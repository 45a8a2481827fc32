"""Device meshes and process groups for sharded fits (port of
``sxmc_tpu/parallel/mesh.py``).

The JAX package maps its math onto a mesh of up to three axes:

  * ``exp``   -- fake experiments (the ensemble axis),
  * ``chain`` -- MCMC chains per experiment,
  * ``event`` -- the event dimension of the NLL reduction (and the MC
    rows of the histogram build),

and ``bin`` for a bin-sharded table (``bin_sharded.make_bin_mesh``).
Here a :class:`Mesh` is a numpy array of ``torch.device`` with those
axis names, driven by one controller: every shard's work is issued from
one thread, each on its own device, and a collective is
:func:`shard_sum`, which moves each shard's result to the axis's first
device and adds them in shard order (deterministic, no
``torch.distributed`` inside one process).  A device may repeat: the CPU
tests build ``[torch.device("cpu")] * 8`` (the JAX tests' 8 virtual CPU
devices), ``chip_smoke.py`` ``[cuda:0] * k`` on its one card.  On
distinct cards the shards' launches stay asynchronous: nothing waits
until a result is gathered.

The process half (``initialize_distributed``,
``process_local_experiments``) spreads the ensemble over processes with
``torch.distributed`` (the gloo backend: a host all-gather of the limits
is all it carries; ``multihost.py``).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sxmc_tpu_torch.utils import resolve_device


class Mesh:
    """Devices laid out on named axes (``jax.sharding.Mesh``'s shape
    and order): ``devices`` an object array of ``torch.device`` whose
    dimensions are ``axis_names``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(np.asarray(devices, dtype=object)[idx])
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-D devices for axes {axis_names}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        """``{axis name: size}`` in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat(self) -> list:
        """Every shard's device, the axes flattened in order (row-major:
        the last axis fastest)."""
        return list(self.devices.reshape(-1))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.flat()})"


def default_devices() -> list:
    """Every card, ``cuda:0 .. device_count - 1``; without CUDA this
    raises (naming ``--device cpu``): a mesh is never made of the CPU
    unless the caller passes CPU devices."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(exp: int = 1, chain: int = 1, event: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """An ``{exp x chain x event}`` mesh over the first ``exp * chain *
    event`` of ``devices`` (default: every card)."""
    if devices is None:
        devices = default_devices()
    n = exp * chain * event
    if n > len(devices):
        raise ValueError(
            f"Mesh {exp}x{chain}x{event} needs {n} devices, "
            f"have {len(devices)}")
    dev = np.empty(n, dtype=object)
    dev[:] = [torch.device(d) for d in list(devices)[:n]]
    return Mesh(dev.reshape(exp, chain, event), ("exp", "chain", "event"))


def auto_mesh(nexperiments: int, nchains: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Pick a mesh: fill the experiment axis first, then chains."""
    if devices is None:
        devices = default_devices()
    nd = len(devices)
    exp = min(nexperiments, nd) if nexperiments > 0 else 1
    while nd % exp != 0:
        exp -= 1
    chain = min(max(nchains, 1), nd // exp)
    while (nd // exp) % chain != 0:
        chain -= 1
    return make_mesh(exp=exp, chain=chain, event=1,
                     devices=list(devices)[:exp * chain])


def local_mesh(nchains: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """``{exp x chain}`` mesh over this process's devices (default:
    every card it sees)."""
    if devices is None:
        devices = default_devices()
    nd = len(devices)
    chain = min(max(nchains, 1), nd)
    while nd % chain != 0:
        chain -= 1
    dev = np.empty(nd, dtype=object)
    dev[:] = [torch.device(d) for d in devices]
    return Mesh(dev.reshape(nd // chain, chain), ("exp", "chain"))


def blocks(n: int, parts: int) -> list:
    """``parts`` contiguous ``(start, stop)`` blocks of ``range(n)``,
    the remainder spread over the first blocks."""
    base, extra = divmod(n, parts)
    out, start = [], 0
    for i in range(parts):
        stop = start + base + (1 if i < extra else 0)
        out.append((start, stop))
        start = stop
    return out


def on(device: torch.device):
    """A context in which ``device`` is the current card (the kernels
    launch on the current device's stream), or nothing for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def shard_sum(parts: Sequence[torch.Tensor],
              device: Optional[torch.device] = None) -> torch.Tensor:
    """The mesh's collective: each shard's ``parts[d]`` moved to
    ``device`` (default: the first shard's) and added in shard order, so
    that the sum does not depend on which shard finishes first."""
    device = parts[0].device if device is None else device
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


# ------------------------------------------------------------ processes

GROUP_TIMEOUT = 600.0  # seconds a collective waits for the other processes


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    init_method: Optional[str] = None,
) -> bool:
    """Start the process group of a multi-process ensemble
    (``torch.distributed``, gloo): ``coordinator_address`` ``host:port``
    becomes ``init_method="tcp://host:port"`` (or pass ``init_method``
    itself, e.g. ``file://...``).  With one process, or none named, no
    group is started, as in the JAX package.  Returns True when a
    group of more than one process is active after the call."""
    import datetime

    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    if not num_processes or num_processes <= 1:
        return False
    if init_method is None:
        if coordinator_address is None:
            raise ValueError("--num-processes > 1 needs --coordinator "
                             "host:port")
        init_method = f"tcp://{coordinator_address}"
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} must lie in "
                         f"[0, {num_processes})")
    dist.init_process_group(
        "gloo", init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    return dist.get_world_size() > 1


def process_index_count() -> Tuple[int, int]:
    """``(rank, world size)`` of the process group, ``(0, 1)`` without
    one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_local_experiments(nexperiments: int,
                              process_index: Optional[int] = None,
                              process_count: Optional[int] = None):
    """Global experiment indices owned by this process: contiguous
    blocks, the remainder spread over the first processes.  Datasets and
    streams are keyed by the global index, so the ensemble's results do
    not depend on the process count."""
    pi, pc = process_index_count()
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    start, stop = blocks(nexperiments, pc)[pi]
    return list(range(start, stop))
