"""Ensemble runner: fake experiments -> fits -> limits.

Port of the Metropolis and tempered branches of
``sxmc_tpu/ensemble.py::run_ensemble`` (reference src/sxmc.cpp:44-148):
for each experiment, generate (or
load) a dataset, run the MCMC, extract the best fit and the upper limit
on the signal of interest, persist the likelihood space, and report the
median limit.  Each experiment runs behind the same fault barrier as
the JAX package's: a failure is logged to the metrics stream with its
traceback, retried under fresh seeds up to ``max_retries`` times, and
then recorded and skipped.

Options outside the ported slice raise ``NotImplementedError`` before
any experiment runs; none of them falls back to another path.
"""

from __future__ import annotations

import os
import traceback
from typing import Callable, List, Optional

import numpy as np
import torch

from sxmc_tpu_torch.fitconfig import FitConfig
from sxmc_tpu_torch.generator import make_fake_dataset
from sxmc_tpu_torch.mcmc.metropolis import MCMC, Presampler
from sxmc_tpu_torch.observability import MetricsLogger, Stopwatch
from sxmc_tpu_torch.stats.diagnostics import summarize
from sxmc_tpu_torch.stats.likelihood import LikelihoodSpace
from sxmc_tpu_torch.utils import median


def check_slice(fc: FitConfig, sampler: str = "metropolis") -> None:
    """Raise NotImplementedError for a configuration the port does not
    run yet, naming the ROADMAP item that will bring it."""
    todo = []
    if sampler in ("hmc", "nuts", "stretch"):
        todo.append(f"sampler {sampler!r} (ROADMAP queue A, item 11)")
    elif sampler == "mle":
        todo.append("sampler 'mle' (ROADMAP queue A, item 10)")
    if todo:
        raise NotImplementedError(
            "not ported to sxmc_tpu_torch yet: " + "; ".join(todo))


def experiment_seeds(seed: int, experiment: int, attempt: int):
    """Independent (data, chain) seeds of one experiment attempt."""
    data_seed, chain_seed = np.random.SeedSequence(
        [seed, experiment, attempt]).generate_state(2, np.uint64)
    return int(data_seed >> np.uint64(1)), int(chain_seed >> np.uint64(1))


def run_ensemble(
    fc: FitConfig,
    output_path: str,
    device="cuda",
    resume: bool = False,
    verbose: bool = True,
    sampler: str = "metropolis",
    max_retries: int = 1,
    dataset_fn: Optional[Callable[[int], np.ndarray]] = None,
    presampler_fn: Optional[Callable[[int], Presampler]] = None,
) -> List[float]:
    """Run the full ensemble on ``device``; returns the upper limits.

    ``dataset_fn(i)`` and ``presampler_fn(i)``, when given, replace
    experiment i's fake dataset and the chain's noise streams (the
    injection point the tests use to run both packages on identical
    inputs).  ``sampler`` is "metropolis" or "tempered" (a replica
    ladder with the JAX package's defaults: 8 temperatures up to 32, a
    swap every 10 steps), whose presampler hands out the tempered
    streams.  Structured metrics go to
    ``<output_path>/<prefix>_metrics.jsonl``.
    """
    check_slice(fc, sampler)
    device = torch.device(device)
    nchains = max(fc.nchains, 1)
    os.makedirs(output_path, exist_ok=True)
    metrics = MetricsLogger(os.path.join(
        output_path, f"{fc.output_prefix}_metrics.jsonl"))
    metrics.log("ensemble_start", nexperiments=fc.nexperiments,
                nsteps=fc.nsteps, sampler=sampler, nchains=fc.nchains,
                device=str(device))

    def log(msg):
        if verbose:
            print(msg)

    mcmc = None
    if not fc.samples and sampler == "tempered":
        from sxmc_tpu_torch.mcmc.tempered import TemperedMCMC

        mcmc = TemperedMCMC(fc.sources, fc.signals, fc.systematics,
                            fc.observables, binned=fc.binned, device=device)
    elif not fc.samples:
        mcmc = MCMC(fc.sources, fc.signals, fc.systematics,
                    fc.observables, device=device, binned=fc.binned)

    # Export the nominal PDFs (sxmc.cpp:45-55) from the fit's stack.
    if fc.plots and not fc.samples:
        from sxmc_tpu_torch.signal import nominal_params

        hists, norms = mcmc.stack.histograms(nominal_params(fc.systematics))
        hists = hists.cpu().numpy()
        norms = norms.cpu().numpy()
        for i, sig in enumerate(fc.signals):
            dens = hists[i].reshape(mcmc.stack.nbins) / max(
                float(norms[i]) * mcmc.stack.bin_volume, 1e-30)
            np.save(os.path.join(output_path, f"{sig.name}_pdf.npy"), dens)

    limits: List[float] = []
    failures: List[dict] = []

    def _run_experiment(i: int, attempt: int) -> None:
        lspace_file = os.path.join(
            output_path, f"{fc.output_prefix}_{i}.{fc.output_format}")
        samples_data = None
        if resume and os.path.exists(lspace_file):
            log(f"ensemble: Resuming from {lspace_file}")
            ls = LikelihoodSpace.load(lspace_file, fc.confidence,
                                      fc.error_type)
        elif fc.samples:
            log(f"ensemble: Loading samples from {fc.samples}")
            ls = LikelihoodSpace.load(fc.samples, fc.confidence,
                                      fc.error_type)
        else:
            data_seed, chain_seed = experiment_seeds(fc.seed, i, attempt)
            if dataset_fn is not None:
                samples_data = np.asarray(dataset_fn(i), np.float32)
            elif not fc.data:
                log(f"ensemble: Sampling fake dataset {i}")
                samples_data = make_fake_dataset(
                    torch.Generator().manual_seed(data_seed), fc.signals,
                    fc.systematics, fc.observables, stack=mcmc.stack,
                    poisson=True, verbose=verbose)
            else:
                chunks = []
                for dataset, sigs in fc.data.items():
                    sig = sigs[i] if i < len(sigs) else sigs[0]
                    log(f"ensemble: Loading dataset {dataset}.{i} "
                        f"({sig.filename})")
                    chunks.append(sig.histogram.get_samples())
                samples_data = np.concatenate(chunks, axis=0)

            extra = ({"rate_substeps": fc.rate_substeps,
                      "proposal": fc.proposal}
                     if sampler == "metropolis" else {})
            sw = Stopwatch()
            ls = mcmc(samples_data, fc.nsteps, fc.burnin_fraction,
                      debug_mode=fc.debug_mode, nchains=nchains,
                      generator=torch.Generator(device).manual_seed(
                          chain_seed),
                      presampler=(presampler_fn(i) if presampler_fn
                                  else None), **extra)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            elapsed = sw.real_time()
            ls.cl = fc.confidence
            ls.error_type = fc.error_type
            ls.save(lspace_file)
            metrics.log(
                "experiment_fit", experiment=i, sampler=sampler,
                nsteps=fc.nsteps, nchains=nchains,
                wall_seconds=elapsed,
                steps_per_sec=fc.nsteps * nchains / max(elapsed, 1e-9),
                accept_rate=mcmc.last_accept_rate)

        log(ls.print_best_fit())
        log(ls.print_correlations())

        # Convergence diagnostics (absent from the reference).  The
        # tempered sampler returns ONE cold chain whatever fc.nchains
        # says; splitting it into pseudo-chains would corrupt R-hat/ESS.
        diag = summarize(ls.samples, list(ls.names),
                         nchains=1 if sampler == "tempered" else nchains)
        log("-- Diagnostics --")
        for pname, d in diag.items():
            log(f" {pname}: ESS={d['ess']:.0f} R-hat={d['rhat']:.3f}")
        metrics.log(
            "experiment_result", experiment=i, nll_min=ls.nll_min,
            best_fit={n: iv.point_estimate
                      for n, iv in ls.get_best_fit().items()},
            ess={n: d["ess"] for n, d in diag.items()},
            rhat={n: d["rhat"] for n, d in diag.items()})

        if fc.plots and samples_data is not None:
            try:
                from sxmc_tpu_torch import plots

                plots.plot_fit(ls.get_best_fit(), fc, samples_data,
                               output_path, suffix=f"_{i}",
                               formats=fc.plot_formats)
            except Exception as e:  # noqa: BLE001 — never fatal to a fit
                log(f"ensemble: plotting failed: {e}")

        # The upper limit on the signal of interest (sxmc.cpp:110-127).
        best_fit = ls.get_best_fit()
        if fc.signal_name and fc.signal_name in best_fit:
            bfi = best_fit[fc.signal_name]
            log(f"ensemble: Signal {fc.signal_name}: {bfi}")
            if not bfi.one_sided:
                log("ensemble: Warning: Two-sided limit!")
            log(f"ensemble: lower = {bfi.lower}, upper = {bfi.upper}, "
                f"coverage = {bfi.coverage}")
            limits.append(bfi.upper)
            metrics.log("experiment_limit", experiment=i,
                        signal=fc.signal_name, upper=bfi.upper,
                        lower=bfi.lower, one_sided=bool(bfi.one_sided))

    for i in range(fc.nexperiments):
        log(f"Experiment {i + 1} / {fc.nexperiments}")
        for attempt in range(max(max_retries, 0) + 1):
            try:
                _run_experiment(i, attempt)
                break
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 — fault barrier
                tb = traceback.format_exc(limit=8)
                metrics.log(
                    "experiment_failed", experiment=i, attempt=attempt,
                    error=f"{type(e).__name__}: {e}", traceback=tb)
                if attempt >= max(max_retries, 0):
                    log(f"ensemble: experiment {i} FAILED after "
                        f"{attempt + 1} attempt(s): {e}")
                    failures.append(
                        {"experiment": i,
                         "error": f"{type(e).__name__}: {e}"})
                else:
                    log(f"ensemble: experiment {i} attempt "
                        f"{attempt} failed ({e}); retrying")

    if failures:
        log(f"ensemble: {len(failures)} experiment(s) failed "
            f"permanently: {[f['experiment'] for f in failures]}")
    metrics.log("ensemble_done", nlimits=len(limits),
                median_limit=float(median(limits)) if limits else -1.0,
                nfailed=len(failures), failures=failures)
    return limits


def main_fit(config_file: str, output_path: str, device="cuda",
             resume: bool = False, data_root: Optional[str] = None,
             max_retries: int = 1,
             binned: Optional[bool] = None,
             rate_substeps: Optional[int] = None,
             sampler: str = "metropolis") -> List[float]:
    """The whole fit from a config file (reference: sxmc.cpp:181-229);
    ``binned`` and ``rate_substeps``, when given, override
    ``fit.binned`` and ``fit.rate_substeps``."""
    print("sxmc_tpu_torch: Loading configuration...")
    print(f"sxmc_tpu_torch: Configuration: {config_file}")
    fc = FitConfig.from_json_file(config_file, data_root=data_root)
    if binned is not None:
        fc.binned = binned
    if rate_substeps is not None:
        fc.rate_substeps = rate_substeps
    print(fc.print())
    print(f"sxmc_tpu_torch: Running ensemble on {device}...")
    limits = run_ensemble(fc, output_path, device=device, resume=resume,
                          max_retries=max_retries, sampler=sampler)
    if limits:
        print("sxmc_tpu_torch: Upper limits:",
              ", ".join(f"{x:g}" for x in limits))
        print(f"sxmc_tpu_torch: Median upper limit: {median(limits)}")
    else:
        print("sxmc_tpu_torch: Median upper limit: -1")
    return limits
