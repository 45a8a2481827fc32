"""Event-sharded NLL: the 10M+ event path (port of
``sxmc_tpu/parallel/nll_sharded.py``).

The reference chunks events with grid-stride partial sums and a
shared-memory reduction (nll_kernels.cpp:97-146, mcmc.cpp:37-44); the
JAX package shards the event axis of the LUT over the mesh's ``event``
axis, takes each shard's log-sum locally and finishes with a psum.  Here
each shard's slice of the LUT lives on its device, its event log-sum is
a float64 sum there (the port's compensated event sum,
``ops.nll.df_sum``), and the collective (``mesh.shard_sum``) adds the
shards' sums in shard order on the axis's first device; the rest of the
NLL (expected counts, constraints, the barrier) follows the port's
``ops.nll.finish_nll``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from sxmc_tpu_torch.ops.nll import (NLLStatic, device_consts, event_logs,
                                    finish_nll, signal_weights, split_pair)
from sxmc_tpu_torch.parallel import mesh as mesh_lib
from sxmc_tpu_torch.parallel.mesh import Mesh


def _event_mesh(mesh: Optional[Mesh]) -> Mesh:
    """``mesh``, or an ``event`` mesh over every card."""
    if mesh is None:
        return mesh_lib.make_mesh(event=len(mesh_lib.default_devices()))
    return mesh


def _event_devices(mesh: Mesh) -> list:
    """The devices along the ``event`` axis (the other axes at 0)."""
    idx = tuple(slice(None) if a == "event" else 0 for a in mesh.axis_names)
    return list(np.atleast_1d(mesh.devices[idx]))


def event_sharded_nll(mesh: Optional[Mesh], st: NLLStatic):
    """``nll(pars, lut_shards, norms)`` with the LUT's event axis split
    over ``mesh``'s ``event`` axis (default: every card): ``lut_shards``
    from :func:`shard_lut`.  Returns the float32 NLL (``hi + lo`` of the
    compensated pair) on the axis's first device; a negative rate or a
    non-finite event sum gives the barrier ``float32(1e18)``."""
    mesh = _event_mesh(mesh)
    devices = _event_devices(mesh)
    consts = {d: device_consts(st, d) for d in set(devices)}

    def nll(pars, lut_shards: Sequence[torch.Tensor], norms):
        parts = []
        for dev, lut in zip(devices, lut_shards):
            c = consts[dev]
            p = torch.as_tensor(pars, dtype=torch.float32).to(dev)
            w = signal_weights(p, torch.as_tensor(
                norms, dtype=torch.float32).to(dev), c)
            parts.append(event_logs(w, lut).to(torch.float64).sum(dim=-1))
        home = devices[0]
        ev_hi, ev_lo = split_pair(mesh_lib.shard_sum(parts, home))
        p = torch.as_tensor(pars, dtype=torch.float32).to(home)
        w = signal_weights(p, torch.as_tensor(
            norms, dtype=torch.float32).to(home), consts[home])
        hi, lo = finish_nll(p, ev_hi, ev_lo, w, consts[home])
        return hi + lo

    return nll


def shard_lut(mesh: Optional[Mesh], lut: torch.Tensor
              ) -> List[torch.Tensor]:
    """Lay a ``(nsignals, nevents)`` LUT out over the ``event`` axis:
    contiguous event blocks (the remainder spread over the first), each
    on its shard's device."""
    devices = _event_devices(_event_mesh(mesh))
    return [lut[:, a:b].to(dev).contiguous() for dev, (a, b) in
            zip(devices, mesh_lib.blocks(lut.shape[-1], len(devices)))]
