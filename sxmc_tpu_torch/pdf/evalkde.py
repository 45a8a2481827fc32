"""Kernel-density PDF evaluator (PyTorch port of ``sxmc_tpu/pdf/evalkde.py``).

The reference declares ``pdfz::EvalKernel`` but never implements it
(pdfz.h:590-625); the JAX package's version is a Gaussian product-kernel
density with per-dimension bandwidths (Scott's rule x a user scale),
truncated and renormalised to the observable domain so that it
integrates to 1 over ``[lower, upper)`` like EvalHist.  Systematics
transform the samples at every evaluation, as in EvalHist.

Two ways into a fit, as in the JAX package:
  * ``histogram(params)``: pseudo-counts on the bin-centre grid, so that
    ``counts[b] / (norm * bin_volume)`` is the density at the centre of
    bin b and a KDE signal joins the binned LUT machinery (PdfStack,
    fake data, plots) unchanged;
  * ``eval_at(points, params)``: the exact density at ``(npoints, nobs
    + 1)`` points (``kde_exact``: fits evaluate it at the events).

:func:`kde_eval` is plain PyTorch, the JAX package's ``_kde_eval`` op for
op: Scott's rule with the population standard deviation (ddof 0) over
every sample, in domain or not; the product Gaussian summed over the
samples one block of points at a time; the truncation mass through
``erf``; then the sentinels in the JAX package's order (dataset mismatch
0, then out of domain NaN, so a point that is both reads NaN).  A block
holds at most ``KDE_BLOCK_BYTES`` of float32 per ``(points, samples,
observables)`` temporary (about four are alive at once).  With autograd
on (the gradient samplers), each block is checkpointed: its backward
recomputes the block instead of keeping its temporaries.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from sxmc_tpu_torch.ops import histogram as hist_ops
from sxmc_tpu_torch.ops import transforms
from sxmc_tpu_torch.pdf.evalhist import EvalHist, PdfError

_SQRT2 = 1.4142135623730951
_INV_SQRT2PI = 0.3989422804014327

# Bytes of one (points, samples, observables) float32 temporary per block.
KDE_BLOCK_BYTES = 1 << 28


class EvalKDE(EvalHist):
    """KDE evaluator with EvalHist's interface (JAX evalkde.py:29-149).

    ``bandwidth_scale`` rescales the per-dimension bandwidths (1.0:
    Scott's rule, pdfz.h:583-589); ``nbins`` sets the grid of
    :meth:`histogram` (64 per observable by default); ``exact_lut``
    makes fits evaluate the density at the events
    (``PdfStack.evaluate(..., use_exact_kde=True)``).
    """

    def __init__(self, samples, nfields: int, nobservables: int,
                 lower: Sequence[float], upper: Sequence[float],
                 bandwidth_scale=None, dataset: int = 0, weights=None,
                 nbins=None, exact_lut: bool = False, device="cuda"):
        nbins = nbins or [64] * nobservables
        if weights is not None:
            raise PdfError("EvalKDE does not support weighted samples.")
        super().__init__(samples, nfields, nobservables, lower, upper,
                         nbins, dataset=dataset, device=device)
        self.exact_lut = bool(exact_lut)
        if bandwidth_scale is None:
            bandwidth_scale = [1.0] * nobservables
        if len(bandwidth_scale) != nobservables:
            raise PdfError(
                "bandwidth_scale size must equal number of observables.")
        self.bandwidth_scale = tuple(float(np.float32(b))
                                     for b in bandwidth_scale)
        self._centers_pts = _bin_center_points(
            self.lower_host, self.upper_host, self.nbins, self.dataset)

    def _params(self, params) -> torch.Tensor:
        if params is None:
            npar = max((max(d.par_indices) + 1 for d in self.systematics),
                       default=0)
            return torch.zeros(npar, dtype=torch.float32, device=self.device)
        if isinstance(params, torch.Tensor):
            return params.to(torch.float32).reshape(-1)
        return torch.as_tensor(np.atleast_1d(np.asarray(params, np.float32)),
                               device=self.device)

    def histogram(self, params=None, samples: Optional[torch.Tensor] = None):
        """KDE pseudo-counts on the bin grid and the in-domain norm:
        ``counts[b] / (norm * bin_volume)`` is the density at bin b's
        centre.  ``samples`` is a field-major ``(nfields, n)`` copy on
        another device (a PdfStack's); the default is this PDF's own."""
        params = self._params(params)
        if samples is None:
            samples = self.device_samples()
        pts = torch.as_tensor(self._centers_pts, device=samples.device)
        dens, norm = kde_eval(samples, pts, params, self)
        return dens * (self.bin_volume * norm), norm

    def eval_points(self, points, params=None):
        """The exact density at host points ``(npoints, nobs + 1)``."""
        points = np.asarray(points, np.float32)
        if points.ndim == 1:
            points = points.reshape(-1, self.nobservables + 1)
        return self.eval_at(torch.as_tensor(points, device=self.device),
                            params)

    def eval_at(self, points: torch.Tensor, params=None,
                samples: Optional[torch.Tensor] = None):
        """The exact density ``(npoints,)`` and norm at ``points`` on the
        samples' device; sentinels as EvalHist's (out of domain NaN,
        dataset mismatch 0)."""
        if samples is None:
            samples = self.device_samples()
        params = (torch.zeros(0, dtype=torch.float32, device=samples.device)
                  if params is None else self._params(params))
        return kde_eval(samples, points, params, self)

    def eval(self, read_bins, params=None):
        raise NotImplementedError(
            "EvalKDE evaluates points directly; use eval_points() / "
            "eval_at().")


def _bin_center_points(lower, upper, nbins, dataset) -> np.ndarray:
    """Bin centres in flat row-major bin order with a dataset tag column:
    the grid of :meth:`EvalKDE.histogram` (JAX evalkde.py:152-169)."""
    nobs = len(nbins)
    total = hist_ops.total_bins(nbins)
    strides = hist_ops.bin_strides(nbins)
    lower = np.asarray(lower, np.float64)
    upper = np.asarray(upper, np.float64)
    widths = (upper - lower) / np.asarray(nbins, np.float64)
    flat = np.arange(total)
    pts = np.empty((total, nobs + 1), np.float32)
    for i, (st, nb) in enumerate(zip(strides, nbins)):
        axis = (flat // st) % nb
        pts[:, i] = lower[i] + (axis + 0.5) * widths[i]
    pts[:, nobs] = float(dataset)
    return pts


def _block_sum(xb: torch.Tensor, obs: torch.Tensor, h: torch.Tensor):
    """mean over samples of exp(-0.5 |(x - s) / h|^2) for a block of
    points ``(b, d)`` against ``obs (n, d)`` (JAX evalkde.py:190-193)."""
    z = (xb[:, None, :] - obs[None, :, :]) / h
    return torch.exp(-0.5 * (z * z).sum(dim=-1)).mean(dim=1)


def _block_sum_inplace(xb: torch.Tensor, obs: torch.Tensor, h: torch.Tensor):
    """:func:`_block_sum`'s operations in place (no autograd): fewer
    temporaries, the same values."""
    z = xb[:, None, :] - obs[None, :, :]
    z.div_(h)
    z.mul_(z)
    s = z.sum(dim=-1) if z.shape[-1] > 1 else z[..., 0]
    return s.mul_(-0.5).exp_().mean(dim=1)


def kde_eval(samples: torch.Tensor, points: torch.Tensor,
             params: torch.Tensor, kde: EvalKDE,
             block_bytes: int = KDE_BLOCK_BYTES):
    """Density ``(npoints,)`` and in-domain count at ``points`` ``(npoints,
    nobs + 1)`` of the KDE of ``samples`` (field-major ``(nfields, n)``)
    under ``params`` (JAX ``_kde_eval``, evalkde.py:172-208)."""
    dev = samples.device
    nobs = kde.nobservables
    lower = torch.tensor(kde.lower_host, dtype=torch.float32, device=dev)
    upper = torch.tensor(kde.upper_host, dtype=torch.float32, device=dev)
    bw = torch.tensor(kde.bandwidth_scale, dtype=torch.float32, device=dev)
    cols = list(samples.unbind(0))
    for desc in kde.systematics:
        cols[desc.obs] = transforms.transform_field(desc, cols, params)
    obs = torch.stack(cols[:nobs], dim=1)                # (n, d)
    in_domain = ((obs >= lower) & (obs < upper)).all(dim=1)
    norm_count = in_domain.sum().to(torch.float32)

    n = obs.shape[0]
    sigma = torch.clamp_min(obs.std(dim=0, correction=0), 1e-6)
    h = sigma * (n ** (-1.0 / (nobs + 4))) * bw         # (d,)

    x = points[:, :nobs]
    kscale = torch.prod(_INV_SQRT2PI / h)
    block = max(1, block_bytes // (4 * max(n, 1) * nobs))
    grad = torch.is_grad_enabled() and (obs.requires_grad or
                                        h.requires_grad)
    parts = []
    for a in range(0, x.shape[0], block):
        xb = x[a:a + block]
        if grad:
            parts.append(checkpoint(_block_sum, xb, obs, h,
                                    use_reentrant=False))
        else:
            parts.append(_block_sum_inplace(xb, obs, h))
    density = (torch.cat(parts) if parts else x.new_zeros(0)) * kscale

    # Truncate and renormalise to the domain: the mean over samples of
    # prod_i [Phi((u_i - s_i) / h_i) - Phi((l_i - s_i) / h_i)].
    cdf_hi = 0.5 * (1.0 + torch.special.erf((upper - obs) / (h * _SQRT2)))
    cdf_lo = 0.5 * (1.0 + torch.special.erf((lower - obs) / (h * _SQRT2)))
    z_mass = torch.prod(cdf_hi - cdf_lo, dim=1).mean()
    density = density / torch.clamp_min(z_mass, 1e-30)

    # Sentinels: 0 on a dataset mismatch, then NaN out of domain
    # (pdfz.cpp:411-436).
    pt_in = ((x >= lower) & (x < upper)).all(dim=1)
    ds_ok = points[:, nobs] == float(kde.dataset)
    density = torch.where(ds_ok, density, torch.zeros_like(density))
    density = torch.where(pt_in, density,
                          torch.full_like(density, float("nan")))
    return density, norm_count
