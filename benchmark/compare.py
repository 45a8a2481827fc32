"""The comparison that decides ``correct``.

Every fit that the window completed is judged by what it produced: its
main-phase states and their NLLs (the likelihood space), and its upper
limit.  At steps drawn from the seed the plain reference
(:mod:`benchmark.reference`) works out again, from the raw tables, the data
and the proposal streams that the benchmark handed to the program:

* ``nll_gap``: the largest distance between the NLL that the program
  recorded for a state and the reference's NLL there (the PDF rebuild under
  the systematics and the event sum);
* ``accept_gap``: the largest distance ``|delta - log u|`` of a decision
  that the program took on the other side of the reference's Metropolis
  rule ``log u <= nll(current) - nll(proposal)`` (1e30 for a chain that
  never moved);
* ``move_gap``: the largest distance of an accepted move (every one of
  the main phase) from ``width * noise``, in units of the width, with the
  width that the chain's moves imply (one per parameter for the phase);
* ``retune_gap``: the same for the set-up's accept-everything fit, from
  the means with the initial widths and then the widths retuned from each
  burn-in phase's RMS: the start and the adaptation, which the main phase
  takes from the program's own state;
* ``limit_gap``: the relative distance between the program's upper limit
  and the contour limit that the reference takes from the same likelihood
  space.

The control puts the reference, computed in bfloat16, in the program's
place on the same states and streams (:func:`judge` with ``control``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import reference as ref

FROZEN = 1e30
NAMES = ("nll_gap", "accept_gap", "move_gap", "retune_gap", "limit_gap")


class Readings:
    """The largest reading of each number over everything judged."""

    def __init__(self):
        self.values = {k: 0.0 for k in NAMES}
        self.counts = {k: 0 for k in NAMES}

    def add(self, name: str, value: float) -> None:
        v = float(value)
        if math.isnan(v):
            v = FROZEN
        self.values[name] = max(self.values[name], v)
        self.counts[name] += 1


def picks(seed: int, unit: int, chain: int, n: int, k: int) -> np.ndarray:
    """``k`` steps of a main phase of ``n`` steps, drawn from the seed; the
    first and the last transition always among them."""
    rng = np.random.default_rng([seed % (1 << 63), 0x5EC, unit, chain])
    inner = np.arange(2, n - 1)
    take = rng.choice(inner, size=min(max(k - 2, 0), inner.size),
                      replace=False) if inner.size else inner
    return np.unique(np.concatenate([[1, n - 1], take])).astype(int)


def _proposal(prev: np.ndarray, noise: np.ndarray, widths: np.ndarray,
              dtype=torch.float32) -> np.ndarray:
    """``prev + width * noise`` where the width is positive, in ``dtype``."""
    p = torch.as_tensor(prev).to(dtype)
    w = torch.as_tensor(widths.astype(np.float32)).to(dtype)
    n = torch.as_tensor(noise).to(dtype)
    y = torch.where(w > 0, p + n * torch.clamp_min(w, 0.0), p)
    return y.float().numpy()


def judge_chain(out: Readings, model: ref.Model, ev: dict,
                states: np.ndarray, nlls: np.ndarray, noise: np.ndarray,
                u: np.ndarray, steps: np.ndarray,
                control: Optional[ref.Model] = None) -> None:
    """Judge one main phase: ``states`` (n, npar) float32 with their NLLs
    (n,), and the phase's streams ``noise`` (n, npar) and ``u`` (n,).
    With ``control`` the program's outputs at the judged steps are
    replaced by the bfloat16 reference's."""
    fixed = model.layout.fixed
    widths = ref.inferred_widths(states[:-1], states[1:], noise[1:], fixed)
    if widths is None:
        out.add("accept_gap", FROZEN)
        return
    moved_all = np.flatnonzero((states[1:] != states[:-1]).any(axis=1)) + 1
    prev_m = states[moved_all - 1]
    if control is None:
        cur_m = states[moved_all]
    else:
        cur_m = _proposal(prev_m, noise[moved_all], widths, control.dtype)
    err = ref.move_errors(prev_m, cur_m, noise[moved_all], widths, fixed)
    out.add("move_gap", float(err.max()))
    for t in steps:
        prev, cur = states[t - 1], states[t]
        moved = bool((cur != prev).any())
        want = _proposal(prev, noise[t], widths)
        n_prev = model.nll(prev, ev)
        lu = math.log(float(u[t])) if u[t] > 0 else -math.inf
        if control is None:
            y = cur if moved else want
            n_y = n_prev if (y == prev).all() else model.nll(y, ev)
            out.add("nll_gap", abs(nlls[t - 1] - n_prev))
            out.add("nll_gap", abs(nlls[t] - (n_y if moved else n_prev)))
            if (y == prev).all():
                continue
            delta = n_prev - n_y
        else:
            if (want == prev).all():
                continue
            n_want = model.nll(want, ev)
            c_prev, c_want = control.nll(prev, ev), control.nll(want, ev)
            out.add("nll_gap", abs(c_prev - n_prev))
            delta = n_prev - n_want
            moved = lu <= c_prev - c_want
        if moved != (lu <= delta):
            out.add("accept_gap", abs(delta - lu))
        else:
            out.add("accept_gap", 0.0)


def judge_limit(out: Readings, layout: ref.Layout, samples: np.ndarray,
                nlls: np.ndarray, limit: float, control: bool = False):
    """The program's upper limit against the contour limit of the same
    likelihood space (with ``control``, the contour taken from the NLLs in
    bfloat16)."""
    col = samples[:, layout.names.index(layout.signal_name)]
    want = ref.contour_upper(col, nlls, layout.confidence)
    if control:
        nl = torch.as_tensor(nlls).to(torch.bfloat16).double().numpy()
        limit = ref.contour_upper(col, nl, layout.confidence)
    out.add("limit_gap", abs(limit - want) / max(abs(want), 1e-30))


def judge_warmup(out: Readings, model: ref.Model, ev: dict,
                 states: np.ndarray, nlls: np.ndarray,
                 streams: List, steps: np.ndarray,
                 control: Optional[ref.Model] = None) -> None:
    """Judge an accept-everything fit through every phase: each move from
    the means must be ``width * noise`` with the initial widths, then the
    widths retuned from the previous phase's states; ``streams`` holds
    each phase's noise (n_k, npar).  The NLLs at ``steps`` are judged as
    in the main phase."""
    lay = model.layout
    fixed = lay.fixed
    widths = lay.initial_widths()
    prev = lay.means.astype(np.float32)
    start = 0
    dtype = torch.float32 if control is None else control.dtype
    for noise in streams:
        n = noise.shape[0]
        cur = states[start:start + n]
        before = np.concatenate([prev[None], cur[:-1]])
        if control is None:
            moved = cur
        else:
            moved = np.stack([_proposal(b, z, widths, dtype)
                              for b, z in zip(before, noise)])
        err = ref.move_errors(before, moved, noise, widths, fixed)
        out.add("retune_gap", float(err.max()) if err.size else 0.0)
        widths = ref.retune(widths, cur if control is None else moved,
                            fixed, lay.nfloat, dtype)
        prev = cur[-1]
        start += n
    for t in steps:
        if t >= states.shape[0]:
            continue
        want = model.nll(states[t], ev)
        got = (nlls[t] if control is None else control.nll(states[t], ev))
        out.add("nll_gap", abs(got - want))


def verdict(readings: Readings, limits: Dict[str, float]) -> bool:
    """True when every number is within its limit and was read."""
    ok = True
    for k in NAMES:
        if readings.counts[k] == 0 or not (readings.values[k] <= limits[k]):
            ok = False
    return ok


def checks_line(readings: Readings, limits: Dict[str, float]) -> dict:
    return {k: {"value": readings.values[k], "limit": limits[k],
                "n": readings.counts[k]} for k in NAMES}
