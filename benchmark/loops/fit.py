"""Traffic ``loop: fit``: one dataset drawn at set-up, then fits back to
back, each the program's ``MCMC.__call__`` with a new proposal stream and
then ``LikelihoodSpace.get_best_fit()`` for the upper limit.  Reports
``chain_steps_per_s``: nsteps x nchains of every fit over the window."""

import time
from typing import List

import torch

from benchmark import compare, harness, reference, tables


def fit_streams(seed: int, tag: int, unit: int, nchains: int, npar: int,
                device):
    """A fit's proposal streams: phase k's noise ``(n, [nchains,] npar)``
    and accept uniforms from a device generator seeded by ``(seed, tag,
    unit, k)``."""
    lead = () if nchains == 1 else (nchains,)

    def presampler(phase: int, n: int):
        gen = torch.Generator(device).manual_seed(
            tables.sub_seed(seed, tag, unit, phase))
        noise = torch.randn((n,) + lead + (npar,), generator=gen,
                            device=device)
        return noise, torch.rand((n,) + lead, generator=gen, device=device)

    return presampler


class Loop:
    """Fits back to back on one dataset."""

    span = "sampler.fit"

    def __init__(self, spec: dict, seed: int, device, host_tables):
        from sxmc_tpu_torch.mcmc.metropolis import MCMC

        self.cfg, self.seed, self.device = spec["cfg"], seed, device
        self.nchains = int(spec["traffic"].get("nchains", 1))
        fc = harness.program_config(self.cfg, host_tables, seed)
        self.layout = reference.Layout(self.cfg["sxmc"])
        self.mcmc = MCMC(fc.sources, fc.signals, fc.systematics,
                         fc.observables, device=device)
        self.npar = self.mcmc.nparameters
        self.nsteps = fc.nsteps
        self.burnin = fc.burnin_fraction
        self.signal = fc.signal_name
        self.data = None
        self.results: List[dict] = []
        self.walls: List[float] = []
        self.warm = None

    def warmup(self, device_tables):
        self.data = tables.fit_data(self.cfg, device_tables, self.seed,
                                    self.device)
        ps = fit_streams(self.seed, 6, 0, self.nchains, self.npar,
                         self.device)
        ls = self.mcmc(self.data, harness.WARM_STEPS, self.burnin,
                       debug_mode=True, nchains=self.nchains, presampler=ps)
        self.warm = dict(samples=ls.samples, nlls=ls.nll_values)
        ps = fit_streams(self.seed, 6, 1, self.nchains, self.npar,
                         self.device)
        self.mcmc(self.data, harness.WARM_STEPS, self.burnin,
                  nchains=self.nchains, presampler=ps).get_best_fit()

    def unit(self, i: int) -> int:
        ps = fit_streams(self.seed, 3, i, self.nchains, self.npar,
                         self.device)
        t0 = time.perf_counter()
        with torch.profiler.record_function(self.span):
            ls = self.mcmc(self.data, self.nsteps, self.burnin,
                           nchains=self.nchains, presampler=ps)
        with torch.profiler.record_function("stats.limit"):
            limit = ls.get_best_fit()[self.signal].upper
        self.walls.append(time.perf_counter() - t0)
        self.results.append(dict(samples=ls.samples, nlls=ls.nll_values,
                                 limit=limit))
        return self.nsteps * self.nchains

    def release(self):
        self.mcmc = None

    def judge(self, model, k: int, control=None) -> compare.Readings:
        out = compare.Readings()
        ev = model.events(self.data)
        nkeep = self.layout.phases(self.nsteps)[-1]
        for i, r in enumerate(self.results):
            noise, u = fit_streams(self.seed, 3, i, self.nchains, self.npar,
                                   self.device)(2, nkeep)
            noise, u = harness.to_numpy(noise), harness.to_numpy(u)
            for c in range(self.nchains):
                sl = slice(c * nkeep, (c + 1) * nkeep)
                z = noise if self.nchains == 1 else noise[:, c]
                uu = u if self.nchains == 1 else u[:, c]
                compare.judge_chain(
                    out, model, ev, r["samples"][sl], r["nlls"][sl], z, uu,
                    compare.picks(self.seed, i, c, nkeep, k), control)
            compare.judge_limit(out, self.layout, r["samples"], r["nlls"],
                                r["limit"], control is not None)
        self._judge_warm(out, model, ev, k, control)
        return out

    def _judge_warm(self, out, model, ev, k, control):
        ps = fit_streams(self.seed, 6, 0, self.nchains, self.npar,
                         self.device)
        lens = self.layout.phases(harness.WARM_STEPS)
        streams = [harness.to_numpy(ps(p, n)[0]) for p, n in enumerate(lens)]
        total = sum(lens)
        for c in range(self.nchains):
            sl = slice(c * total, (c + 1) * total)
            zs = [z if self.nchains == 1 else z[:, c] for z in streams]
            compare.judge_warmup(
                out, model, ev, self.warm["samples"][sl],
                self.warm["nlls"][sl], zs,
                compare.picks(self.seed, 10 ** 6, c, total, k), control)

    def end_to_end(self, elapsed: float, units: int, work: int) -> dict:
        return {"chain_steps_per_s": {"value": work / elapsed,
                                      "unit": "steps/s"}}

    def step_events(self, model) -> List[float]:
        """Events of each experiment that one step sweeps."""
        return [self.data.shape[0]]
