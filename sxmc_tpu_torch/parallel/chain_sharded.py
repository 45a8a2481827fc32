"""Event-sharded MCMC chain: the 10M+ event / 10M+ MC-row path (port of
``sxmc_tpu/parallel/chain_sharded.py``).

Both the dynamic signals' MC rows (the histogram build) and the data
events (the NLL's event sum) are split over the mesh's ``event`` axis,
in contiguous blocks.  Each proposal's NLL, when a systematic floats:

    every shard: B1 on its rows (its own segment offsets, so its own
                 ``HistSpec`` and B1 plan)   --sum-->  the dynamic rows
    the table:   the static rows (built once) beside the summed counts
    every shard: B2 on its events, then its compensated event sum
                 (float64)                   --sum-->  the event term
    then the expected counts, constraints and barrier (ops.nll)

where a sum is ``mesh.shard_sum`` (each shard's part moved to the axis's
first device and added in shard order).  Unweighted counts summed over
shards equal the unsharded counts exactly (weighted: each shard's
float64 sums rounded to float32, then added); the event term differs
from the unsharded one only by the order of its float64 additions.  With
no floating systematic (or no dynamic signal) the table is built once
and each shard's LUT once.

Static-segment skip, as in the JAX package: only signals a systematic
touches have rows to shard (``PdfStack``'s dynamic segments); the
others are the stack's theta-invariant table.

The walk is single-controller: one proposal and accept stream for the
whole chain (not one per shard), through ``metropolis.run_chain``'s
stepper with this NLL (its accept ``delta > 0`` or ``u <= exp(delta)``,
three phases, width retunes).  Draws come from ``seed`` or an injected
``presampler``, so the sharded chain can be held decision by decision
against the unsharded stepper on the same draws.  B1's accumulator is
kept per device and stream (``ops.kernels``): the shards of one device
launch in order on its current stream, so they share it safely.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sxmc_tpu_torch.mcmc import metropolis
from sxmc_tpu_torch.mcmc.metropolis import MCMC, Presampler
from sxmc_tpu_torch.ops import kernels
from sxmc_tpu_torch.ops.nll import (device_consts, event_logs, finish_nll,
                                    signal_weights, split_pair)
from sxmc_tpu_torch.parallel import mesh as mesh_lib
from sxmc_tpu_torch.parallel.mesh import Mesh
from sxmc_tpu_torch.parallel.nll_sharded import _event_devices, _event_mesh
from sxmc_tpu_torch.stats.likelihood import LikelihoodSpace


class ShardedNLL:
    """The event-sharded chain's NLL for one dataset: ``nll(params)`` ->
    the compensated ``(hi, lo)`` pair on the mesh's first device, for
    ``(npar,)`` params.  ``histograms(theta)`` gives the summed table
    and norms (every shard's B1, then the sum)."""

    def __init__(self, mcmc: MCMC, read_bins: torch.Tensor, mesh: Mesh):
        stack = mcmc.stack
        self.mcmc = mcmc
        self.devices = _event_devices(mesh)
        self.home = self.devices[0]
        self.ns = mcmc.nsources
        self.consts = {d: device_consts(mcmc.static, d)
                       for d in set(self.devices)}
        self.rebuild = metropolis._syst_float(mcmc) and stack._ndyn > 0
        # The MC rows: contiguous blocks of the dynamic segments.
        hs = stack.hist_spec
        self.shards = []
        if hs is not None:
            off = np.asarray(hs.seg_off)
            for dev, (a, b) in zip(self.devices, mesh_lib.blocks(
                    hs.n, len(self.devices))):
                spec = kernels.HistSpec.build(
                    hs.nfields, hs.lower, hs.upper, hs.nbins,
                    hs.systematics, np.clip(off, a, b) - a, hs.weighted)
                self.shards.append(
                    (spec, stack.samples[:, a:b].to(dev).contiguous()))
        # The events: contiguous blocks of the read bins.
        self.rbs = [read_bins[:, a:b].to(dev).contiguous()
                    for dev, (a, b) in zip(self.devices, mesh_lib.blocks(
                        read_bins.shape[-1], len(self.devices)))]
        self.plans = [kernels.LutPlan(rb, stack.bin_volume)
                      for rb in self.rbs]  # B2's, one a shard
        self.luts = None
        if not self.rebuild:
            theta0 = torch.as_tensor(mcmc.parameter_means[self.ns:],
                                     dtype=torch.float32, device=self.home)
            self.luts = self._luts(*self.histograms(theta0))

    def histograms(self, theta: torch.Tensor):
        """``(nsignals, total)`` table and ``(nsignals,)`` norms at
        ``theta`` on the first device: every shard's B1 on its rows,
        summed in shard order, beside the static rows."""
        stack = self.mcmc.stack
        hists = stack.hist_init.to(self.home).clone()
        norms = stack._norm_init_t.to(self.home).clone()
        if self.shards:
            parts = []
            for spec, x in self.shards:
                with mesh_lib.on(x.device):
                    parts.append(kernels.segmented_histogram(
                        spec, x, theta.to(x.device).contiguous()))
            idx = stack._dyn_idx_t.to(self.home)
            hists[idx] = mesh_lib.shard_sum([p[0] for p in parts], self.home)
            norms[idx] = mesh_lib.shard_sum([p[1] for p in parts], self.home)
        return hists, norms

    def _luts(self, hists, norms):
        out = []
        for plan in self.plans:
            dev = plan.device
            with mesh_lib.on(dev):
                nd = norms.to(dev)
                out.append((plan(hists.to(dev), nd), nd))
        return out

    def __call__(self, params: torch.Tensor):
        if params.dim() != 1:
            raise ValueError("the event-sharded chain is one chain: params "
                             f"(npar,), got {tuple(params.shape)}")
        luts = self.luts
        if luts is None:
            luts = self._luts(*self.histograms(params[self.ns:]))
        parts = []
        for (lut, norms), dev in zip(luts, self.devices):
            w = signal_weights(params.to(dev), norms, self.consts[dev])
            parts.append(event_logs(w, lut).to(torch.float64).sum(dim=-1))
        ev_hi, ev_lo = split_pair(mesh_lib.shard_sum(parts, self.home))
        c = self.consts[self.home]
        w = signal_weights(params, luts[0][1].to(self.home), c)
        return finish_nll(params, ev_hi, ev_lo, w, c)


def run_sharded_chain(
    mcmc: MCMC,
    data: np.ndarray,
    nsteps: int,
    burnin_fraction: float = 0.1,
    mesh: Optional[Mesh] = None,
    seed: int = 0,
    debug_mode: bool = False,
    presampler: Optional[Presampler] = None,
) -> LikelihoodSpace:
    """Run one chain with the MC rows and the events split over
    ``mesh``'s ``event`` axis (default: every card); the draws come from
    a ``torch.Generator`` on the mesh's first device seeded with
    ``seed``, or from ``presampler``.  ``mcmc`` must live on that device
    (the unbinned likelihood; KDE signals are refused, as in the JAX
    package)."""
    mesh = _event_mesh(mesh)
    stack = mcmc.stack
    if stack.has_kde:
        raise NotImplementedError(
            "Event-sharded chains support binned PDFs only; KDE signals "
            "evaluate on the replicated path.")
    if mcmc.binned:
        raise ValueError("the event-sharded chain sums the unbinned "
                         "likelihood's events; build the MCMC with "
                         "binned=False")
    home = _event_devices(mesh)[0]
    if home != mcmc.device:
        raise ValueError(f"mcmc is on {mcmc.device}, the mesh's first "
                         f"device is {home}")
    rb = stack.compute_read_bins(np.asarray(data, np.float32))
    nll = ShardedNLL(mcmc, rb, mesh)
    burnin_steps = int(nsteps * burnin_fraction)
    if presampler is None:
        gen = torch.Generator(home).manual_seed(seed)

        def presampler(phase, n):
            return metropolis.presample(gen, n, mcmc.nparameters, home)

    samples, nlls, accept = metropolis.run_chain(
        mcmc, rb, nsteps, burnin_steps, debug_mode, presampler,
        chain_nll=nll)
    mcmc.last_accept_rate = float(accept)
    return LikelihoodSpace.from_arrays(
        samples.cpu().numpy(), metropolis.nll_history_to_f64(nlls),
        mcmc.parameter_names)
