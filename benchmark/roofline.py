"""Peaks of the card and the work of one chain step, from the cell's shapes.

The least time of a step is the larger of its bytes over the card's memory
bandwidth and its operations over its float32 rate outside the tensor cores
(NVIDIA H100 SXM data sheet: 3.35 TB/s, 67 TFLOP/s, at the 700-W limit;
the run records the card's ``power.limit`` beside it).  The work is the
algorithm's, whatever kernel or route carries it:

* bytes: each MC row's fields that the rebuild reads (the observables, the
  fields a systematic moves and its truth fields), once per step for all
  lock-step chains; each event's observables and tag once; each chain's
  histogram of every rebuilt signal written once, float32;
* operations, per rebuilt MC row and chain: each systematic's transform
  (shift 1, scale 1, ctscale 3, resolution_scale 3, each power-series term
  past the first 2, and 1 more per power past the first), the binning per
  observable (subtract, multiply, floor, two compares: 5, and a multiply and
  an add for each further observable) and the count (1); per event and
  chain, 3 a signal (density, weight, add), the log and the sum (2).
"""

from __future__ import annotations

from typing import Sequence, Tuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

_TRANSFORM_OPS = {"shift": 1, "scale": 1, "ctscale": 3,
                  "resolution_scale": 3}


def row_ops(systs, nobs: int) -> int:
    """Operations per rebuilt MC row and chain."""
    ops = 0
    for y in systs:
        k = len(y["pidx"])
        ops += _TRANSFORM_OPS[y["type"]] + 2 * (k - 1) + max(k - 2, 0)
    return ops + 5 * nobs + 2 * (nobs - 1) + 1


def step_work(model, nevents: Sequence[int], nchains: int
              ) -> Tuple[float, float]:
    """``(bytes, operations)`` of one step of ``len(nevents)`` experiments
    (their event counts) with ``nchains`` lock-step chains each, over the
    reference ``model``'s cut tables."""
    nobs = len(model.layout.observables)
    nsig = len(model.sigs)
    nexp = len(nevents)
    byts = 0.0
    row_flops = 0.0
    ndyn = 0
    for s in model.sigs:
        if not s["systs"]:
            continue
        ndyn += 1
        byts += 4.0 * s["nrows"] * len(s["cols"])
        row_flops += float(s["nrows"]) * row_ops(s["systs"], nobs)
    byts += sum(4.0 * n * (nobs + 1) for n in nevents)
    byts += 4.0 * nexp * nchains * ndyn * model.total
    flops = nexp * nchains * row_flops
    flops += nchains * sum(float(n) * (3 * nsig + 2) for n in nevents)
    return byts, flops


def least_seconds(byts: float, flops: float) -> float:
    return max(byts / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)
