"""Autotuner for B1 (the segmented histogram), with a persisted cache
(port of ``sxmc_tpu/ops/autotune.py``).

The reference brute-forces CUDA launch configurations at the first
evaluation with a 10% improvement hysteresis (reference:
EvalHist::Optimize{,Bin,Eval}, pdfz.cpp:622-814).  The JAX package tunes
the one free parameter of its Pallas kernels, the sample chunk.  The
port's B1 (``csrc/sxmc_hist.cu``) has two: its blocks and its
shared-memory slots, which ``sx_hist_grid``'s rule picks (as many blocks
as fit on the card at once, up to the chunks; the slots that fit the
budget).  The sweep runs out of the fit, on the card (``python -m
sxmc_tpu_torch.ops.autotune --record``): 1-4 blocks per SM, within the
occupancy of each slot count that B1's shared memory allows, timed on
the card (CUDA graphs of launches, CUDA events); a verdict replaces the
rule only if it is
at least 10% faster than the rule's own measurement (the reference's
hysteresis, pdfz.cpp:712-719).  The wrapper reads the cache where it
makes B1's plan, at the first launch for a layout, chain count and
device (``ops.kernels.b1_grid``).

Key: ``kind:total_nbins:nsegments:bucket(nsamples):nchains:form``, the
JAX key plus the chain count and the form (``u`` unweighted, ``w``
weighted), which change B1's shared memory and slots; ``kind`` is
``global`` for one segment (the JAX package's ``pallas_histogram``) and
``segmented`` otherwise.  A verdict stores its grid and time and the
rule's.

Cache: ``$SXMC_TPU_TORCH_AUTOTUNE_CACHE`` or
``~/.cache/sxmc_tpu_torch/autotune.json``, laid over the shipped
verdicts in ``sxmc_tpu_torch/data/autotune_h100.json`` (recorded on an
H100; its header names the card and its power limit).  A file is
``{"card": ..., "verdicts": {key: record}}``; a corrupt one is ignored.
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Dict, Optional, Tuple

_CACHE_ENV = "SXMC_TPU_TORCH_AUTOTUNE_CACHE"

Grid = Tuple[int, int]  # (blocks, slots)


def cache_path() -> str:
    p = os.environ.get(_CACHE_ENV)
    if p:
        return p
    return os.path.join(os.path.expanduser("~"), ".cache", "sxmc_tpu_torch",
                        "autotune.json")


def shipped_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "data", "autotune_h100.json")


def _read(path: str) -> dict:
    """A cache file's verdicts, or {} when it is missing or corrupt."""
    try:
        with open(path) as f:
            got = json.load(f)
    except (OSError, ValueError):
        return {}
    verdicts = got.get("verdicts") if isinstance(got, dict) else None
    return verdicts if isinstance(verdicts, dict) else {}


def load_cache() -> dict:
    """Shipped verdicts overlaid by the user cache (user wins)."""
    cache = _read(shipped_path())
    cache.update(_read(cache_path()))
    return cache


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "unknown"


def save_cache(cache: dict, card_name: Optional[str] = None) -> None:
    """Write ``cache`` (verdicts) to :func:`cache_path`, atomically, with
    the card it was recorded on in the header."""
    p = cache_path()
    os.makedirs(os.path.dirname(os.path.abspath(p)), exist_ok=True)
    tmp = p + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"card": card_name if card_name is not None else card(),
                   "recorded_by": "python -m sxmc_tpu_torch.ops.autotune "
                                  "--record",
                   "verdicts": cache}, f, indent=1, sort_keys=True)
    os.replace(tmp, p)


def _bucket(n: int) -> int:
    """Power-of-two sample-count bucket (tunings generalize within)."""
    b = 1
    while b * 2 <= max(n, 1):
        b *= 2
    return b


def kind_of(hs) -> str:
    """``global`` for a one-segment layout, else ``segmented``."""
    return "global" if hs.ndyn == 1 else "segmented"


def cache_key(kind: str, total_nbins: int, nsegments: int, nsamples: int,
              nchains: int = 1, weighted: bool = False) -> str:
    return (f"{kind}:{total_nbins}:{nsegments}:{_bucket(nsamples)}:"
            f"{nchains}:{'w' if weighted else 'u'}")


def tuned_grid(kind: str, total_nbins: int, nsegments: int, nsamples: int,
               nchains: int, weighted: bool, heuristic: Grid,
               cache: Optional[dict] = None) -> Grid:
    """Production lookup: the recorded ``(blocks, slots)`` for this
    shape, or ``heuristic`` (sx_hist_grid's rule) when none is
    recorded."""
    if cache is None:
        cache = load_cache()
    rec = cache.get(cache_key(kind, total_nbins, nsegments, nsamples,
                              nchains, weighted))
    if isinstance(rec, dict) and "blocks" in rec and "slots" in rec:
        return int(rec["blocks"]), int(rec["slots"])
    return tuple(heuristic)


MIN_CREDIBLE_SECONDS = 1e-7  # a time below this is a timing failure


def record_tuning(kind: str, total_nbins: int, nsegments: int,
                  nsamples: int, nchains: int, weighted: bool,
                  results: Dict[Grid, float], heuristic: Grid,
                  hysteresis: float = 0.10,
                  card_name: Optional[str] = None) -> Optional[Grid]:
    """Persist a sweep's verdict with the reference's 10% hysteresis:
    the best grid replaces the heuristic only if it beats the
    heuristic's own time by more than ``hysteresis`` (pdfz.cpp:712-719).
    Times below ``MIN_CREDIBLE_SECONDS`` are dropped first.  A verdict
    that confirms the heuristic is recorded too (the grid then the
    heuristic's), so the cache documents a measured verdict either way.
    Returns the new grid, or None when the heuristic stays."""
    heuristic = tuple(heuristic)
    credible = {tuple(g): s for g, s in results.items()
                if s >= MIN_CREDIBLE_SECONDS}
    if not credible:
        return None
    best = min(credible, key=credible.get)
    base = credible.get(heuristic)
    confirmed = base is not None and \
        credible[best] > (1.0 - hysteresis) * base
    pick = heuristic if confirmed else best
    cache = load_cache()
    cache[cache_key(kind, total_nbins, nsegments, nsamples, nchains,
                    weighted)] = {
        "blocks": int(pick[0]), "slots": int(pick[1]),
        "seconds": credible[pick],
        "heuristic_blocks": int(heuristic[0]),
        "heuristic_slots": int(heuristic[1]),
        "heuristic_seconds": base,
    }
    save_cache(cache, card_name)
    return None if confirmed else (int(best[0]), int(best[1]))


# ----------------------------------------------------------- the sweep


def candidate_grids(hs, nch: int, dev) -> list:
    """The sweep's ``(blocks, slots)``: for every slot count B1's shared
    memory allows (0, then powers of two up to the most that fit), 1-4
    blocks per SM within that slot count's occupancy, capped at the
    chunks; the rule's grid first."""
    from sxmc_tpu_torch.ops import kernels

    rule = kernels.b1_grid(hs, nch, dev, tuned=False)
    _, most, chunks, nsm = kernels.b1_limits(hs, nch, dev, 0)
    slots = [0] + [1 << k for k in range(6) if (1 << k) <= most]
    grids = [rule]
    for s in slots:
        occ = kernels.b1_limits(hs, nch, dev, s)[0]
        for bps in range(1, min(4, occ) + 1):
            g = (int(min(chunks, nsm * bps)), s)
            if g not in grids:
                grids.append(g)
    return grids


ROUNDS = 5  # replays of a sweep's graph between two CUDA events


def _graph_seconds(launch, device, reps: int) -> float:
    """Seconds per call of ``launch`` on the card: ``reps`` calls
    captured in a CUDA graph (no host between them), the graph replayed
    ROUNDS times between two CUDA events, the median over three such
    timings."""
    import torch

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        launch()  # makes the stream's B1 accumulator outside the capture
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            launch()
    graph.replay()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ROUNDS):
            graph.replay()
        stop.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(stop) * 1e-3 / (ROUNDS * reps))
    return sorted(times)[1]


def sweep(hs, samples, theta, reps: int = 20) -> Dict[Grid, float]:
    """Seconds per B1 launch on the card at each of
    :func:`candidate_grids`, from a CUDA graph of ``reps`` launches
    replayed ROUNDS times (:func:`_graph_seconds`): the card's time,
    without the host's issue gaps between calls."""
    from sxmc_tpu_torch.ops import kernels

    nch = theta.shape[0] if theta.dim() == 2 else 1
    return {tuple(g): _graph_seconds(
        lambda g=g: kernels.launch_histogram_at(hs, samples, theta, nch, g),
        samples.device, reps)
        for g in candidate_grids(hs, nch, samples.device)}


def shapes(device):
    """The recorded shapes: ``{name: (HistSpec, samples, theta)}`` on
    ``device``: the JAX file's two (``global:1000:1:524288``: 1M rows of
    one field under a shift, 1,000 bins; ``segmented:1000:29:4194304``:
    29 segments of 4.9M rows in all, no systematic, 1,000 bins), the
    reference example's layout (2 x 500,000 rows, 10 bins, a
    scale and a resolution systematic) and the same at 8 chains, each
    drawn from a seed."""
    import numpy as np
    import torch

    from sxmc_tpu_torch.ops import kernels
    from sxmc_tpu_torch.ops.transforms import (RESOLUTION_SCALE, SCALE,
                                               SHIFT, SystematicDesc)

    out = {}
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 0.15, (1, 1_000_000)).astype(np.float32)
    hs = kernels.HistSpec.build(
        1, [0.0], [1.0], [1000],
        [(SystematicDesc(SHIFT, obs=0, par_indices=(0,)), (True,))],
        [0, x.shape[1]])
    out["global:1000:1:524288"] = (
        hs, torch.as_tensor(x, device=device),
        torch.full((1,), 1e-3, dtype=torch.float32, device=device))
    rng = np.random.default_rng(29)
    raw = np.exp(rng.uniform(np.log(1e3), np.log(3e6), 29))
    counts = np.maximum((raw * (4.9e6 / raw.sum())).astype(int), 100)
    x = rng.normal(0.5, 0.15, (1, int(counts.sum()))).astype(np.float32)
    hs = kernels.HistSpec.build(1, [0.0], [1.0], [1000], [],
                                np.concatenate([[0], np.cumsum(counts)]))
    out["segmented:1000:29:4194304"] = (
        hs, torch.as_tensor(x, device=device),
        torch.zeros(1, dtype=torch.float32, device=device))
    # The reference example's layout (examples/make_example.py): energy
    # and the truth energy, scale on both signals, resolution on both.
    rng = np.random.default_rng(7)
    n = 500_000
    true = np.concatenate([rng.uniform(1.0, 5.0, n),
                           rng.normal(3.0, 0.5, n)]).astype(np.float32)
    reco = (true + rng.normal(0, 0.1, 2 * n)).astype(np.float32)
    x = np.stack([reco, true])
    systs = [(SystematicDesc(SCALE, obs=0, par_indices=(0,)), (True, True)),
             (SystematicDesc(RESOLUTION_SCALE, obs=0, par_indices=(1,),
                             extra_field=1), (True, True))]
    hs = kernels.HistSpec.build(2, [0.0], [6.0], [10], systs, [0, n, 2 * n])
    xs = torch.as_tensor(x, device=device)
    out[f"reference example, 2 x {n} rows"] = (
        hs, xs, torch.tensor([0.01, 0.02], dtype=torch.float32,
                             device=device))
    th = torch.as_tensor(rng.normal(0, 0.02, (8, 2)).astype(np.float32),
                         device=device)
    out["reference example, 8 chains"] = (hs, xs, th)
    return out


def record(device="cuda", reps: int = 20) -> dict:
    """Sweep every shape of :func:`shapes` on ``device`` and record each
    verdict (:func:`record_tuning`) into :func:`cache_path`.  Returns
    ``{name: {"key", "rule", "times" {grid: seconds}, "recorded"}}``."""
    from sxmc_tpu_torch.ops import kernels
    from sxmc_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    card_name = card()
    out = {}
    for name, (hs, x, th) in shapes(dev).items():
        nch = th.shape[0] if th.dim() == 2 else 1
        rule = kernels.b1_grid(hs, nch, dev, tuned=False)
        times = sweep(hs, x, th, reps)
        got = record_tuning(kind_of(hs), hs.total, hs.ndyn, hs.n, nch,
                            hs.weighted, times, rule, card_name=card_name)
        key = cache_key(kind_of(hs), hs.total, hs.ndyn, hs.n, nch,
                        hs.weighted)
        out[name] = {"key": key, "rule": list(rule),
                     "times": {f"{b} blocks, {s} slots": t
                               for (b, s), t in times.items()},
                     "recorded": list(got) if got else None}
        for (b, s), t in times.items():
            tag = " (rule)" if (b, s) == tuple(rule) else ""
            print(f"autotune {key}: {b} blocks, {s} slots: "
                  f"{t * 1e3:.4f} ms{tag}")
        print(f"autotune {key}: verdict "
              f"{got if got else 'the rule ' + str(tuple(rule))}")
    return out


def main(argv=None):
    """``python -m sxmc_tpu_torch.ops.autotune [--record]``: sweep B1's
    grids on the card and print the times; with ``--record``, keep the
    verdicts in the cache."""
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if "--record" in argv:
        out = record()
    else:
        from sxmc_tpu_torch.utils import resolve_device

        out = {name: {f"{b} blocks, {s} slots": t
                      for (b, s), t in sweep(hs, x, th).items()}
               for name, (hs, x, th) in shapes(
                   resolve_device("cuda")).items()}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
