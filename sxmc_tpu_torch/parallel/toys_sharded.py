"""Sharded toy-fit batches: the statistics tier over a device mesh (port
of ``sxmc_tpu/parallel/toys_sharded.py``).

The toy engines (Feldman-Cousins belts, pull studies) are batched BFGS
solves, independent across toys.  Here the padded toy batch is split
over the mesh's shards (every axis flattened, in order): each shard runs
the port's batched solve (``stats.feldman_cousins.toy_dnll_batch``,
``stats.bias.toy_fit_batch``) on its slice, on its own device (a model
per distinct device), and the results are concatenated in order.  A row
of the batched BFGS is frozen once it finishes (every update a
``torch.where`` on its masks), so its result does not depend on which
other rows share its batch: the sharded results equal the unsharded
ones.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from sxmc_tpu_torch.parallel import mesh as mesh_lib
from sxmc_tpu_torch.parallel.mesh import Mesh


def _pad_to_devices(arr: torch.Tensor, ndev: int
                    ) -> Tuple[torch.Tensor, int]:
    """Pad the leading axis to a multiple of ``ndev`` by repeating row 0
    (the pad rows' results are dropped); returns ``(padded, n)``."""
    n = arr.shape[0]
    m = math.ceil(n / ndev) * ndev
    if m == n:
        return arr, n
    pad = arr[:1].expand((m - n,) + tuple(arr.shape[1:]))
    return torch.cat([arr, pad], dim=0), n


def _model_on(mle, device: torch.device):
    """``mle`` itself on its own device, else the same fit built on
    ``device``."""
    from sxmc_tpu_torch.stats.mle import MLE

    if torch.device(device) == mle.device:
        return mle
    return MLE(mle.sources, mle.signals, mle.systematics, mle.observables,
               device=device, binned=mle.binned, maxiter=mle.maxiter)


def _split(mesh: Mesh, mle, leading, solve):
    """Pad the toy-axis tensors ``leading`` to the mesh, run ``solve(model,
    *slices)`` on each shard's slice on its device (shards issued in
    turn), and concatenate each result's rows in order, un-padded."""
    devices = mesh.flat()
    padded = []
    for a in leading:
        a, n = _pad_to_devices(torch.as_tensor(a), len(devices))
        padded.append(a)
    per = padded[0].shape[0] // len(devices)
    models = {}
    outs = []
    for d, dev in enumerate(devices):
        if dev not in models:
            models[dev] = _model_on(mle, dev)
        sl = [a[d * per:(d + 1) * per].to(dev).contiguous() for a in padded]
        with mesh_lib.on(dev):
            outs.append(solve(models[dev], *sl))
    return tuple(np.concatenate([o[k] for o in outs])[:n]
                 for k in range(len(outs[0])))


def sharded_toy_dnll(mesh: Mesh, mle, r_values, read_bins_batch, k: int,
                     free_idx) -> Tuple[np.ndarray, np.ndarray]:
    """``stats.feldman_cousins.toy_dnll_batch`` with the toy axis split
    over ``mesh``: ``(dnll, rhat)`` as numpy, un-padded."""
    from sxmc_tpu_torch.stats.feldman_cousins import toy_dnll_batch

    def solve(model, rv, rb):
        return toy_dnll_batch(model, rv.cpu().numpy(), rb, k, free_idx)

    rv = torch.as_tensor(np.asarray(r_values, np.float32))
    return _split(mesh, mle, (rv, read_bins_batch), solve)


def sharded_pull_batch(mesh: Mesh, mle, read_bins_batch, free_idx
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """``stats.bias.toy_fit_batch`` with the toy axis split over
    ``mesh``: ``(r_hat, sigma_hat)`` as numpy, un-padded."""
    from sxmc_tpu_torch.stats.bias import toy_fit_batch

    def solve(model, rb):
        return toy_fit_batch(model, rb, free_idx)

    return _split(mesh, mle, (read_bins_batch,), solve)
