"""Systematic transformations of MC sample fields (PyTorch).

Port of ``sxmc_tpu/ops/transforms.py`` (reference ``apply_systematic``,
src/pdfz.cpp:306-331).  The per-systematic shift ``p`` is a power series
in the current value of the affected observable,

    p = sum_i  theta[par_index[i]] * x**i

and the four types are

    SHIFT:            x' = x + p
    SCALE:            x' = x * (1 + p)
    CTSCALE:          x' = 1 + (x - 1) * (1 + p)
    RESOLUTION_SCALE: x' = x + p * (x - x_true)

applied in order, a later systematic seeing the fields the earlier ones
produced.  The op order is the JAX package's (transforms.py:99-119,
pallas_hist.py:77-103) operation for operation, in float32, so that a
sample on a bin edge lands in the same bin in both packages and in the
CUDA kernels (which build with ``-fmad=false`` for the same reason).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

SHIFT = 0
SCALE = 1
RESOLUTION_SCALE = 2
CTSCALE = 3

_TYPE_NAMES = {
    "shift": SHIFT,
    "scale": SCALE,
    "resolution_scale": RESOLUTION_SCALE,
    "ctscale": CTSCALE,
}


def systematic_type_from_name(name: str) -> int:
    """Map the JSON DSL type string to a type id (systematic.cpp:21-39)."""
    try:
        return _TYPE_NAMES[name]
    except KeyError:
        raise ValueError(f"Unknown systematic type: {name!r}")


@dataclasses.dataclass(frozen=True)
class SystematicDesc:
    """Static description of one systematic acting on one PDF.

    Attributes:
        type: One of SHIFT / SCALE / CTSCALE / RESOLUTION_SCALE.
        obs: Column index of the affected observable field.
        par_indices: Indices of the power-series coefficients p_0..p_{n-1}
            in the systematic-parameter vector.
        extra_field: Column index of the truth field (RESOLUTION_SCALE only).
    """

    type: int
    obs: int
    par_indices: Tuple[int, ...]
    extra_field: int = 0

    @property
    def npars(self) -> int:
        return len(self.par_indices)


def transform_field(desc: SystematicDesc, cols: List[torch.Tensor],
                    theta: torch.Tensor) -> torch.Tensor:
    """The new value of field ``desc.obs`` after one systematic.

    ``cols`` are the current float32 field columns; ``theta`` the
    float32 systematic-parameter vector.
    """
    x = cols[desc.obs]
    # p = sum_i theta[pidx_i] * x^i from 0.0 in ascending i, as the
    # kernels sum it.  The first term, 0.0 + theta * 1.0, does not
    # depend on x (and theta * 1.0 == theta), so it stays one value (one
    # per chain) and broadcasts: the same bits in fewer array passes.
    p = 0.0 + theta[desc.par_indices[0]]
    xi = x
    for i, pidx in enumerate(desc.par_indices[1:]):
        if i > 0:
            xi = xi * x
        p = p + theta[pidx] * xi
    if desc.type == SHIFT:
        return x + p
    if desc.type == SCALE:
        return x * (1.0 + p)
    if desc.type == CTSCALE:
        return 1.0 + (x - 1.0) * (1.0 + p)
    if desc.type == RESOLUTION_SCALE:
        return x + p * (x - cols[desc.extra_field])
    raise ValueError(f"Unknown systematic type id {desc.type}")


def apply_systematics(
    samples: torch.Tensor,
    params: torch.Tensor,
    systematics: Sequence[SystematicDesc],
) -> torch.Tensor:
    """Apply all systematics in order to a ``(nsamples, nfields)`` array.

    (The per-segment masked form is ``ops.kernels``' plain rebuild.)
    """
    if not systematics:
        return samples
    cols = [samples[:, i] for i in range(samples.shape[1])]
    for desc in systematics:
        cols[desc.obs] = transform_field(desc, cols, params)
    return torch.stack(cols, dim=1)
