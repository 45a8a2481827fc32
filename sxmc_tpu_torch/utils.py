"""Small helpers, typed errors and the device/dtype policy.

Copied from ``sxmc_tpu/utils.py`` (which cannot be imported here: the
``sxmc_tpu`` package pulls in jax at import), plus the two policies the
PyTorch port adds: the device is always explicit, and data enters as
float32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class ConfigError(ValueError):
    """Invalid fit configuration (bad JSON values, conflicting keys)."""


class FitError(RuntimeError):
    """A fit or statistics operation cannot proceed (degenerate
    likelihood space, malformed sample files, empty contours)."""


def median(values: Sequence[float]) -> float:
    """Median (utils.h:76-90)."""
    return float(np.median(np.asarray(values)))


def resolve_device(device) -> torch.device:
    """The torch device a run uses; ``cuda`` without CUDA raises.

    There is no silent fallback: a run asked to use the card either
    gets it or fails here, before any work is done.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() "
            "is False; pass --device cpu to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def as_f32(x, device) -> torch.Tensor:
    """Float32 tensor on ``device``.

    ``torch.as_tensor`` of a numpy float64 array keeps float64, which
    would silently run the whole NLL in double; every entry point into
    the port goes through this guard instead.
    """
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


def segment_seed(seed: int, phase: int, seg: int) -> int:
    """The seed of one segment's streams in a segmented run (the sharded
    ensemble's, a checkpointed chain's), the same whether or not the run
    was interrupted before."""
    s = np.random.SeedSequence([seed, 7000 + phase, seg]).generate_state(
        1, np.uint64)[0]
    return int(s >> np.uint64(1))
