"""Multi-process ensemble: experiments fanned out over processes (port
of ``sxmc_tpu/parallel/multihost.py``).

The reference runs its sensitivity ensemble in a serial host loop on
one GPU (reference: src/sxmc.cpp:59-145).  Here each process of a
``torch.distributed`` group (``mesh.initialize_distributed``, gloo) owns
a contiguous block of global experiment indices
(``mesh.process_local_experiments``), draws and fits only those, as one
batch on its own device (``parallel.ensemble.fit_batch``: the grouped
kernels on the card), and the per-experiment limits are all-gathered as
a float64 CPU tensor and summed, so that every process holds the same
vector; the caller's process 0 writes the outputs.

Process-count invariance: experiment i's dataset is the one the
one-process ensemble draws for it (``ensemble.experiment_seeds``), its
chains' streams are its slice of the whole ensemble's segment streams
(``parallel.ensemble.default_streams``: every process draws them all and
keeps its block, so memory is the one-process run's), and every block
is padded to the longest dataset of the whole ensemble (the local
lengths are all-gathered first).  A chain computes alone in every
kernel and plain version, so the gathered limits equal a one-process
run's bit for bit.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from sxmc_tpu_torch.fitconfig import FitConfig
from sxmc_tpu_torch.parallel import ensemble as ens
from sxmc_tpu_torch.parallel import mesh as mesh_lib
from sxmc_tpu_torch.stats.likelihood import LikelihoodSpace
from sxmc_tpu_torch.utils import resolve_device


def _all_gather(x: torch.Tensor) -> List[torch.Tensor]:
    """Every process's ``x`` (a CPU tensor of one shape), in rank order;
    ``[x]`` without a process group."""
    import torch.distributed as dist

    _, count = mesh_lib.process_index_count()
    if count == 1:
        return [x]
    out = [torch.empty_like(x) for _ in range(count)]
    dist.all_gather(out, x)
    return out


def run_multihost_ensemble(
    fc: FitConfig,
    nsteps: Optional[int] = None,
    verbose: bool = True,
    poisson: bool = True,
    device="cuda",
) -> Tuple[List[Optional[LikelihoodSpace]], np.ndarray]:
    """Run ``fc.nexperiments`` fits spread over the process group's
    processes, each on ``device`` (the card unless the caller asks for
    the CPU).  ``poisson=False`` draws each signal's expected count
    exactly (the datasets then have one length everywhere).

    Returns ``(lspaces, limits)``: per global experiment, its likelihood
    space (None where another process fitted it) and the ``(nexp,)``
    gathered upper limits, the same on every process."""
    nsteps = nsteps or fc.nsteps
    dev = resolve_device(device)
    nexp = fc.nexperiments
    local = mesh_lib.process_local_experiments(nexp)
    rank, count = mesh_lib.process_index_count()
    if verbose:
        print(f"multihost: process {rank}/{count} owns experiments {local}")

    mcmc = ens.MCMC(fc.sources, fc.signals, fc.systematics,
                    fc.observables, device=dev, binned=fc.binned)
    if mcmc.stack._kde_exact:
        raise NotImplementedError(
            "the multihost driver does not thread per-experiment "
            "event-coordinate extras (the single-host sharded "
            "ensemble does, parallel/ensemble.py); use "
            "kde_exact=false here.")
    datasets = ens.draw_datasets(fc, mcmc.stack, local, poisson=poisson)
    # Every block is padded to the longest dataset of the ensemble.
    longest = max((d.shape[0] for d in datasets), default=0)
    nev = int(max(int(t) for t in _all_gather(
        torch.tensor([longest], dtype=torch.int64))))

    lspaces: List[Optional[LikelihoodSpace]] = [None] * nexp
    local_limits = torch.zeros(nexp, dtype=torch.float64)
    if local:
        batch = ens.pad_datasets(datasets, nev)
        rb = mcmc.stack.compute_read_bins(batch)
        nchains = max(fc.nchains, 1)
        m = (fc.rate_substeps if ens.metropolis._blocked_enabled(
            mcmc, fc.rate_substeps) else 0)
        whole = ens.default_streams(fc.seed, nexp, nchains,
                                    mcmc.nparameters, m, dev)
        e0, e1 = local[0], local[-1] + 1

        def streams(phase, seg, n):
            noise, u = whole(phase, seg, n)
            return (noise[..., e0:e1, :, :].contiguous(),
                    u[..., e0:e1, :].contiguous())

        samples, nlls, _, _ = ens.fit_batch(fc, mcmc, rb, batch, nsteps,
                                            streams)
        mine, limits = ens._collect_results(fc, mcmc, samples, nlls,
                                            verbose, local)
        for k, gi in enumerate(local):
            lspaces[gi] = mine[k]
            if limits:
                local_limits[gi] = limits[k]

    # Zeros in the slots a process does not own: the sum of the
    # gathered vectors is the whole vector, the same on every process.
    limits = torch.stack(_all_gather(local_limits)).sum(dim=0)
    return lspaces, limits.numpy()
