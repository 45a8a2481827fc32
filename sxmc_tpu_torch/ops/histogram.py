"""Bin ids and segmented histograms (PyTorch, plain versions).

Port of ``sxmc_tpu/ops/histogram.py``.  Bin-index semantics match the
reference exactly (pdfz.cpp:388-398): an event is in-domain iff
``lower <= x < upper`` for every observable, and the flat bin id is
``sum_i floor((x_i - lower_i) * scale_i) * stride_i`` with row-major
strides (pdfz.cpp:207-215).

``scale_i`` follows ``compute_bin_ids``' float32 convention
(histogram.py:79-87): ``f32(nbins) / (f32(upper) - f32(lower))``.  It is
computed once on the host (:func:`bin_scales`) and the same float32
value goes to the plain versions here and to the CUDA kernels, so the
two bin every sample identically.

The TPU needed a two-level one-hot matmul because it has no atomics;
here the plain histogram is ``torch.bincount`` and the card runs the
hand-written kernel in ``ops/kernels.py`` (shared-memory atomics).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def bin_strides(nbins: Sequence[int]) -> Tuple[int, ...]:
    """Row-major bin strides (reference: pdfz.cpp:207-215)."""
    ndims = len(nbins)
    strides = [1] * ndims
    for i in range(ndims - 2, -1, -1):
        strides[i] = nbins[i + 1] * strides[i + 1]
    return tuple(strides)


def total_bins(nbins: Sequence[int]) -> int:
    t = 1
    for n in nbins:
        t *= n
    return t


def bin_volume(lower: Sequence[float], upper: Sequence[float],
               nbins: Sequence[int]) -> float:
    """Volume of one bin (reference: pdfz.cpp:201-204)."""
    v = 1.0
    for lo, up, n in zip(lower, upper, nbins):
        v *= (up - lo) / n
    return v


def bin_scales(lower: Sequence[float], upper: Sequence[float],
               nbins: Sequence[int]) -> np.ndarray:
    """Per-observable float32 ``nbins / (upper - lower)``, divided in f32."""
    lo = np.asarray(lower, np.float32)
    up = np.asarray(upper, np.float32)
    return (np.asarray(nbins, np.float32) / (up - lo)).astype(np.float32)


def compute_bin_ids(
    obs: torch.Tensor,
    lower: Sequence[float],
    upper: Sequence[float],
    nbins: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat bin ids + in-domain mask for ``(n, nobs)`` float32 points.

    Returns ``(ids, valid)``: ``(n,)`` int64 flat bin ids (clipped into
    range for invalid points) and the ``(n,)`` bool in-domain mask.
    """
    return bin_ids_of_columns([obs[:, i] for i in range(len(nbins))],
                              lower, upper, nbins)


def bin_ids_of_columns(cols, lower: Sequence[float], upper: Sequence[float],
                       nbins: Sequence[int], dtype=torch.int64
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`compute_bin_ids` of observables given as one float32 tensor
    each (``cols[i]`` the i-th observable, all of one shape, or
    broadcasting to one): ``(ids, valid)`` of that shape, the ids of
    integer type ``dtype``."""
    strides = bin_strides(nbins)
    scales = bin_scales(lower, upper, nbins)
    ids = valid = None
    for i in range(len(nbins)):
        x = cols[i]
        lo = float(np.float32(lower[i]))
        up = float(np.float32(upper[i]))
        ok = (x >= lo) & (x < up)
        # float32 ops, in the JAX package's order: (x - lo) * scale.
        axis = torch.floor((x - lo) * float(scales[i])).to(dtype)
        axis = axis.clamp(0, nbins[i] - 1)
        if strides[i] != 1:
            axis = axis * strides[i]
        valid = ok if valid is None else valid & ok
        ids = axis if ids is None else ids + axis
    return ids, valid


def segmented_histogram(ids: torch.Tensor, valid: torch.Tensor,
                        segment_ids: torch.Tensor, num_segments: int,
                        num_bins: int) -> torch.Tensor:
    """Exact ``(num_segments, num_bins)`` int64 counts of in-domain ids.

    Replaces the reference's atomicAdd scatter (pdfz.cpp:401-404) and
    the JAX package's one-hot matmul bincount (histogram.py:158-200).
    """
    flat = segment_ids.to(torch.int64) * num_bins + ids
    counts = torch.bincount(flat[valid], minlength=num_segments * num_bins)
    return counts.reshape(num_segments, num_bins)
