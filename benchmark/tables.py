"""The benchmark's inputs, made on the device from ``--seed``.

A configuration's ``tables`` section gives, per signal, the number of
Monte-Carlo rows and how each field is drawn, in order:

* ``["normal", mean, sigma]``, ``["uniform", low, high]``,
* ``["exponential", offset, scale]``: offset plus an exponential draw,
* ``["smear", field, sigma]``: an earlier field plus a normal draw.

Each field is one call of a ``torch.Generator`` on the device, in float32.
The data events of a fit are drawn the same way (fresh rows) and kept where
every observable and cut field lies in its range (the sxmc data section's
clipping, config.cpp:280-287), as many a signal as a Poisson draw of its
expected count keeps under a fixed seed; a data row is ``(observables...,
dataset tag)``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def sub_seed(seed: int, *words: int) -> int:
    """A 63-bit seed for one purpose, from the run's seed and ``words``."""
    s = np.random.SeedSequence([int(seed)] + [int(w) for w in words])
    return int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))


def draw_rows(spec: dict, n: int, gen: torch.Generator, device
              ) -> Tuple[torch.Tensor, List[str]]:
    """``n`` rows of the fields in ``spec["fields"]``, ``(n, nfields)``."""
    cols: Dict[str, torch.Tensor] = {}
    names = []
    for name, kind, a, b in spec["fields"]:
        if kind == "normal":
            x = torch.randn(n, generator=gen, device=device) * b + a
        elif kind == "uniform":
            x = torch.rand(n, generator=gen, device=device) * (b - a) + a
        elif kind == "exponential":
            x = torch.empty(n, device=device).exponential_(
                1.0 / b, generator=gen) + a
        elif kind == "smear":
            x = cols[a] + torch.randn(n, generator=gen, device=device) * b
        else:
            raise ValueError(f"unknown field kind {kind!r}")
        cols[name] = x.to(torch.float32)
        names.append(name)
    return torch.stack([cols[k] for k in names], dim=1), names


def mc_tables(cfg: dict, seed: int, device) -> Dict[str, tuple]:
    """Every signal's MC table: ``{signal: (rows (n, nfields), names)}``."""
    out = {}
    for i, name in enumerate(cfg["sxmc"]["fit"]["signals"]):
        spec = cfg["tables"][name]
        gen = torch.Generator(device).manual_seed(sub_seed(seed, 1, i))
        out[name] = draw_rows(spec, int(spec["rows"]), gen, device)
    return out


def _clipped(cfg: dict, rows: torch.Tensor, names: List[str]) -> torch.Tensor:
    """The rows whose observables and cut fields lie in their ranges."""
    sx = cfg["sxmc"]
    obs = sx["pdfs"]["observables"]
    keep = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    fit = sx["fit"]
    for o in list(fit["observables"]) + list(fit.get("cuts", [])):
        col = rows[:, names.index(obs[o]["field"])]
        keep &= (col >= obs[o]["min"]) & (col <= obs[o]["max"])
    return rows[keep]


def fit_data(cfg: dict, tables: Dict[str, tuple], seed: int, device
             ) -> np.ndarray:
    """One dataset of a fit: per signal, as many events as a draw from a
    fixed seed keeps (its expected count Poisson fluctuated, clipped to the
    observables' and cuts' ranges), drawn as fresh rows from the run's seed
    and clipped alike.  Every seed gets the same number of events, so every
    run has the same sizes.  ``(nevents, nobs + 1)`` float32 on the host."""
    sx = cfg["sxmc"]
    obs = sx["pdfs"]["observables"]
    fit = sx["fit"]
    chunks = []
    for i, name in enumerate(fit["signals"]):
        conf = sx["signals"][name]
        spec = cfg["tables"][name]
        n_mc = tables[name][0].shape[0]
        nexp = (float(conf["rate"]) if "rate" in conf
                else n_mc / float(conf["scale"]))
        fixed = torch.Generator(device).manual_seed(sub_seed(0, 2, i))
        n = int(torch.poisson(torch.tensor([nexp], device=device),
                              generator=fixed)[0])
        rows, names = draw_rows(spec, n, fixed, device)
        want = _clipped(cfg, rows, names).shape[0]
        gen = torch.Generator(device).manual_seed(sub_seed(seed, 2, i))
        kept = []
        while sum(k.shape[0] for k in kept) < want:
            rows, _ = draw_rows(spec, 2 * n + 1024, gen, device)
            kept.append(_clipped(cfg, rows, names))
        rows = torch.cat(kept)[:want]
        cols = [rows[:, names.index(obs[o]["field"])]
                for o in fit["observables"]]
        tag = torch.full_like(cols[0], float(conf["dataset"]))
        chunks.append(torch.stack(cols + [tag], dim=1))
    return torch.cat(chunks).cpu().numpy()
