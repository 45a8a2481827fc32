"""Bin-dimension sharding: PDFs too large for one device's memory (port
of ``sxmc_tpu/parallel/bin_sharded.py``).

A high-dimensional PDF (5 observables x 20 bins = 3.2M bins x nsignals)
can outgrow one device once multiplied by chains and experiments; the
reference has no analog (one GPU holds one histogram, pdfz.cpp:
158-175).  Here the flat bin axis, padded to a multiple of the mesh's
``bin`` axis, is split into contiguous ranges, one per shard:

  * build: each shard bins the (replicated) dynamic samples into ONLY
    its range -- no collective; the static rows are the stack's
    theta-invariant table, sliced.  The norms (every bin's count) are
    the same on every shard; the first shard's are returned.
  * eval: each shard looks up the events whose read bin falls in its
    range and contributes zero elsewhere; one collective
    (``mesh.shard_sum``) reassembles the ``(nsignals, nevents)`` LUT,
    and the sentinels come after it, from the replicated read bins (-1
    -> NaN out of domain, -2 -> 0 dataset mismatch; pdfz.cpp:289-301).

The JAX package builds this with ``jnp`` outside any Pallas kernel; so
does the port, in plain PyTorch (``ops.transforms``,
``ops.histogram``), with B1's arithmetic: exact integer counts, weighted
sums in float64 rounded once.  The LUT feeds
``nll_sharded.event_sharded_nll`` once laid out over an event axis.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from sxmc_tpu_torch.ops import histogram as hist_ops
from sxmc_tpu_torch.ops import transforms
from sxmc_tpu_torch.parallel import mesh as mesh_lib
from sxmc_tpu_torch.parallel.mesh import Mesh
from sxmc_tpu_torch.utils import as_f32


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def padded_bins(total_nbins: int, mesh: Mesh) -> int:
    """Flat bin count padded to a multiple of the ``bin`` axis size."""
    return _pad_to(total_nbins, mesh.shape["bin"])


def make_bin_mesh(ndev: int = 0, devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh whose one axis is the bin dimension, over the first
    ``ndev`` (default all) of ``devices`` (default: every card)."""
    devs = mesh_lib.default_devices() if devices is None else list(devices)
    if ndev <= 0:
        ndev = len(devs)
    arr = np.empty(ndev, dtype=object)
    arr[:] = [torch.device(d) for d in devs[:ndev]]
    return Mesh(arr, ("bin",))


def _local_counts(stack, theta: torch.Tensor, lo: int, local: int,
                  device) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's ``(nsignals, local)`` table of bins ``[lo, lo +
    local)`` and the ``(nsignals,)`` norms, on ``device``."""
    hists = torch.zeros((stack.nsignals, local), dtype=torch.float32,
                        device=device)
    hi = min(lo + local, stack.total_nbins)
    if hi > lo:
        hists[:, :hi - lo] = stack.hist_init[:, lo:hi].to(device)
    norms = stack._norm_init_t.to(device).clone()
    hs = stack.hist_spec
    if hs is None:
        return hists, norms
    samples = stack.samples.to(device)
    theta = theta.to(device)
    cols = [samples[f] for f in range(hs.nfields)]
    sizes = torch.as_tensor(np.diff(hs.seg_off), device=device)
    seg = torch.repeat_interleave(
        torch.arange(hs.ndyn, device=device), sizes)
    for desc, mask in hs.systematics:
        new = transforms.transform_field(desc, cols, theta)
        on = torch.as_tensor(mask, device=device)[seg]
        cols[desc.obs] = torch.where(on, new, cols[desc.obs])
    ids, valid = hist_ops.bin_ids_of_columns(cols[:hs.nobs], hs.lower,
                                             hs.upper, hs.nbins)
    w = (samples[hs.nfields].to(torch.float64) if hs.weighted
         else torch.ones(hs.n, dtype=torch.float64, device=device))
    mine = valid & (ids >= lo) & (ids < lo + local)
    flat = seg * (local + 1) + torch.where(mine, ids - lo, local)
    cells = hs.ndyn * (local + 1)
    if hs.weighted:
        dyn = torch.zeros(cells, dtype=torch.float64, device=device)
        dyn.index_add_(0, flat, w)
        dn = torch.zeros(hs.ndyn, dtype=torch.float64, device=device)
        dn.index_add_(0, seg, torch.where(valid, w, torch.zeros_like(w)))
    else:
        dyn = torch.bincount(flat, minlength=cells)
        dn = torch.bincount(seg[valid], minlength=hs.ndyn)
    dyn = dyn.reshape(hs.ndyn, local + 1)[:, :local]
    idx = stack._dyn_idx_t.to(device)
    hists[idx] = dyn.to(torch.float32)
    norms[idx] = dn.to(torch.float32)  # weighted: float64, rounded once
    return hists, norms


def bin_sharded_histograms(mesh: Mesh, stack, theta_syst
                           ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Every signal's histograms with the bin axis split over ``mesh``'s
    ``bin`` axis: ``(shards, norms)``, ``shards[d]`` the ``(nsignals,
    padded_bins / nbin)`` float32 table of shard d's bin range on its
    device (pad bins zero), ``norms`` the ``(nsignals,)`` in-domain
    counts (weight sums) on the first shard's device."""
    if getattr(stack, "has_kde", False):
        raise NotImplementedError(
            "bin-sharded builds support binned PDFs only")
    devices = list(mesh.devices.reshape(-1))
    local = padded_bins(stack.total_nbins, mesh) // len(devices)
    theta = as_f32(theta_syst, stack.device).reshape(-1)
    shards, norms = [], None
    for d, dev in enumerate(devices):
        h, n = _local_counts(stack, theta, d * local, local, dev)
        shards.append(h)
        norms = n if norms is None else norms
    return shards, norms


def bin_sharded_eval(mesh: Mesh, hists_sharded: Sequence[torch.Tensor],
                     norms: torch.Tensor, read_bins: torch.Tensor,
                     bin_volume: float) -> torch.Tensor:
    """The ``(nsignals, nevents)`` LUT from a bin-sharded table: each
    shard resolves the events whose read bin lies in its range, one
    collective adds the shards' parts, then the sentinels (-1 -> NaN, -2
    -> 0) from the read bins.  On the first shard's device."""
    devices = list(mesh.devices.reshape(-1))
    local = hists_sharded[0].shape[1]
    bv = float(np.float32(bin_volume))
    parts = []
    for d, (dev, h) in enumerate(zip(devices, hists_sharded)):
        rb = read_bins.to(dev).to(torch.int64)
        pos = rb - d * local
        mine = (pos >= 0) & (pos < local)
        counts = torch.gather(h, 1, pos.clamp(0, local - 1))
        counts = torch.where(mine, counts, torch.zeros_like(counts))
        parts.append(counts / (norms.to(dev)[:, None] * bv))
    home = devices[0]
    vals = mesh_lib.shard_sum(parts, home)
    rb = read_bins.to(home)
    vals = torch.where(rb == -2, torch.zeros_like(vals), vals)
    return torch.where(rb == -1, torch.full_like(vals, float("nan")), vals)
