"""Ensemble runner: fake experiments -> fits -> limits.

Port of ``sxmc_tpu/ensemble.py::run_ensemble`` for the Metropolis,
tempered and gradient-MLE samplers (reference src/sxmc.cpp:44-148): for
each experiment, generate (or load) a dataset, run the fit, extract the
best fit and the upper limit on the signal of interest, persist the
result, and report the median limit.  The frequentist tier hangs off it
as in the JAX package: hypothesis tests per experiment
(``{prefix}_hypotest_{i}.json``), a pull study before the first
experiment (``{prefix}_pulls.json``) and a goodness-of-fit check after
each fit.  Each experiment runs behind the same fault barrier as the JAX
package's: a failure is logged to the metrics stream with its
traceback, retried under fresh seeds up to ``max_retries`` times, and
then recorded and skipped.

Options outside the ported slice raise ``NotImplementedError`` before
any experiment runs; none of them falls back to another path.
"""

from __future__ import annotations

import json
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
    if sampler in ("hmc", "nuts", "stretch"):
        raise NotImplementedError(
            f"not ported to sxmc_tpu_torch yet: sampler {sampler!r} "
            "(ROADMAP queue A, item 11)")


def experiment_seeds(seed: int, experiment: int, attempt: int):
    """Independent (data, chain) seeds of one experiment attempt."""
    data_seed, chain_seed = np.random.SeedSequence(
        [seed, experiment, attempt]).generate_state(2, np.uint64)
    return int(data_seed >> np.uint64(1)), int(chain_seed >> np.uint64(1))


def _generator(device, *entropy) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``entropy`` (the
    toy streams of the hypothesis tests, the GOF and the pull study: the
    JAX package's fold_in keys 7, 11 and seed + 0x5A5A)."""
    (seed,) = np.random.SeedSequence(list(entropy)).generate_state(
        1, np.uint64)
    return torch.Generator(device).manual_seed(int(seed >> np.uint64(1)))


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
    hypotest_toys: int = 0,
    hypotest_band: bool = False,
    hypotest_asymptotic: bool = False,
    gof_toys: int = -1,
    bias_toys: int = 0,
) -> List[float]:
    """Run the full ensemble on ``device``; returns the upper limits.

    ``dataset_fn(i)`` and ``presampler_fn(i)``, when given, replace
    experiment i's fake dataset and the chain's noise streams (the
    injection point the tests use to run both packages on identical
    inputs).  ``sampler`` is "metropolis", "tempered" (a replica ladder
    with the JAX package's defaults: 8 temperatures up to 32, a swap
    every 10 steps; its presampler hands out the tempered streams) or
    "mle" (the gradient fit: ``{prefix}_mle_{i}.json`` per experiment,
    the limit the one-sided profile-likelihood limit).

    The frequentist tier, with the JAX package's options:
    ``hypotest_toys > 0`` runs the q0 discovery test and the toy CLs
    limit on ``fit.signal_name`` for every experiment (with
    ``hypotest_band`` the expected band too), ``hypotest_asymptotic``
    the Asimov limit and band; ``gof_toys >= 0`` a saturated-chi2
    goodness of fit at each best fit (with that many posterior-
    predictive toys when > 0); ``bias_toys > 0`` a pull study before the
    first experiment.  Structured metrics go to
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
    if not fc.samples and sampler == "mle":
        from sxmc_tpu_torch.stats.mle import MLE

        mcmc = MLE(fc.sources, fc.signals, fc.systematics, fc.observables,
                   device=device, binned=fc.binned)
    elif not fc.samples and sampler == "tempered":
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

    ht = None
    want_hypotest = hypotest_toys > 0 or hypotest_asymptotic
    if want_hypotest and fc.signal_name:
        from sxmc_tpu_torch.stats.hypotest import HypoTest
        from sxmc_tpu_torch.stats.mle import MLE

        est = mcmc if isinstance(mcmc, MLE) else MLE(
            fc.sources, fc.signals, fc.systematics, fc.observables,
            device=device)
        try:
            ht = HypoTest(est, fc.signal_name)
        except ValueError as e:
            log(f"ensemble: hypotest disabled: {e}")
    elif want_hypotest:
        log("ensemble: hypotest requires fit.signal_name")

    if bias_toys > 0 and not fc.samples:
        _run_pull_study(fc, mcmc, ht, bias_toys, output_path, device,
                        metrics, log)

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

            if ht is not None:
                _run_hypotest(ht, fc, samples_data, output_path, i,
                              hypotest_toys, hypotest_band,
                              _generator(device, fc.seed, i, attempt, 7),
                              log, asymptotic=hypotest_asymptotic)
            if sampler == "mle":
                limit = _run_mle_experiment(
                    mcmc, fc, samples_data, output_path, i, log,
                    gof_toys=gof_toys, metrics=metrics,
                    gof_gen=_generator(device, fc.seed, i, attempt, 11))
                if limit is not None:
                    limits.append(limit)
                return

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

        if gof_toys >= 0 and samples_data is not None:
            from sxmc_tpu_torch.stats.gof import goodness_of_fit

            bf = ls.get_best_fit()
            best_params = np.asarray(
                [bf[n].point_estimate for n in mcmc.parameter_names],
                np.float32)
            gof = goodness_of_fit(
                fc.sources, fc.signals, fc.systematics, fc.observables,
                samples_data, best_params, ntoys=max(gof_toys, 0),
                gen=_generator(device, fc.seed, i, attempt, 11),
                stack=mcmc.stack, refit=True)
            log(f"-- Goodness of fit --\n {gof}")
            metrics.log("experiment_gof", experiment=i, chi2=gof.chi2,
                        ndof=gof.ndof, p_asymptotic=gof.p_asymptotic,
                        p_toys=gof.p_toys)

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


def _run_pull_study(fc: FitConfig, mcmc, ht, ntoys: int, output_path: str,
                    device, metrics, log) -> None:
    """The pre-fit pull study of the free rates (stats.bias), once per
    ensemble: ``{prefix}_pulls.json`` and a ``pull_study`` metrics record
    (JAX ensemble.py:152-187)."""
    from sxmc_tpu_torch.stats.bias import pull_study
    from sxmc_tpu_torch.stats.mle import MLE

    est = (ht.mle if ht is not None else
           mcmc if isinstance(mcmc, MLE) else
           MLE(fc.sources, fc.signals, fc.systematics, fc.observables,
               device=device))
    ps = pull_study(est, ntoys, _generator(device, fc.seed + 0x5A5A),
                    cl=fc.confidence)
    log(str(ps))
    summary = ps.summary()
    metrics.log("pull_study", ntoys=ntoys, cl=fc.confidence,
                summary=summary)
    with open(os.path.join(output_path, f"{fc.output_prefix}_pulls.json"),
              "w") as f:
        json.dump({"ntoys": ntoys, "cl": fc.confidence, "summary": summary},
                  f, indent=1)
    if fc.plots:
        try:
            from sxmc_tpu_torch.plots import plot_pulls

            plot_pulls(ps, os.path.join(output_path,
                                        f"{fc.output_prefix}_pulls.png"))
        except Exception as e:  # noqa: BLE001 — never fatal to a fit
            log(f"bias study: plotting failed: {e}")


def _run_hypotest(ht, fc: FitConfig, data, output_path: str, index: int,
                  ntoys: int, band: bool, gen: torch.Generator, log,
                  asymptotic: bool = False) -> None:
    """Discovery significance + CLs limit for the signal of interest
    (JAX ensemble.py:404-486): the CLs grid runs from an eighth of to
    twice the profile-likelihood limit; results go to
    ``{prefix}_hypotest_{i}.json``.  ``asymptotic`` adds the Asimov CLs
    limit and band (the only limit when ``ntoys == 0``)."""
    cl = max(fc.confidence, 0.9)
    disc = ht.discovery(data, ntoys=ntoys, gen=gen)
    log(f"hypotest: Discovery {fc.signal_name}: {disc}")
    result = ht.mle.fit(data)
    lim0 = ht.mle.upper_limit(fc.signal_name, cl, result)
    hi = max(2.0 * lim0, 1e-2)
    grid = np.linspace(hi / 8.0, hi, 8)
    out = {
        "signal": fc.signal_name, "cl": cl, "ntoys": ntoys,
        "q0": disc.q0, "z_asymptotic": disc.z_asymptotic,
        "p_asymptotic": disc.p_asymptotic, "z_toys": disc.z_toys,
        "p_toys": disc.p_toys, "profile_limit": lim0,
        "r_grid": list(grid),
    }
    limit = cls_vals = bd = None
    if ntoys > 0:
        limit, grid, cls_vals = ht.cls_upper_limit(gen, data, grid,
                                                   ntoys=ntoys, cl=cl)
        log(f"hypotest: CLs upper limit ({cl:.0%} CL): {limit:g} "
            f"(profile-likelihood: {lim0:g})")
        out["cls_limit"] = limit
        out["cls_values"] = list(cls_vals)
        out["r_grid"] = list(grid)  # the refined points merged in
    if band and ntoys > 0:
        bd = ht.cls_expected_band(gen, grid, ntoys=ntoys, cl=cl,
                                  background_fit=result,
                                  quantiles=(0.16, 0.5, 0.84))
        log(f"hypotest: Expected limit (median [-1s, +1s]): "
            f"{bd[0.5]:g} [{bd[0.16]:g}, {bd[0.84]:g}]")
        out["expected_limit"] = {str(k): v for k, v in bd.items()}
    if asymptotic:
        asym = ht.asymptotic_upper_limit(data, grid, cl=cl)
        log(f"hypotest: Asymptotic (Asimov) {asym}")
        out["asymptotic_limit"] = asym.limit
        out["asymptotic_expected"] = {str(n): v
                                      for n, v in asym.expected.items()}
        out["asymptotic_cls_values"] = list(asym.cls_obs)
        if limit is None:
            limit, cls_vals = asym.limit, asym.cls_obs
            bd = {0.16: asym.expected[-1], 0.5: asym.expected[0],
                  0.84: asym.expected[1]}
    with open(os.path.join(output_path,
                           f"{fc.output_prefix}_hypotest_{index}.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    if fc.plots and cls_vals is not None:
        try:
            from sxmc_tpu_torch import plots

            plots.plot_cls_scan(
                grid, cls_vals, limit, cl,
                os.path.join(output_path,
                             f"{fc.output_prefix}_cls_{index}.png"),
                signal_name=fc.signal_name, expected=bd)
        except Exception as e:  # noqa: BLE001 — never fatal to a fit
            log(f"hypotest: plotting failed: {e}")


def _run_mle_experiment(mle, fc: FitConfig, samples_data, output_path: str,
                        index: int, log, gof_toys: int = -1, metrics=None,
                        gof_gen: Optional[torch.Generator] = None
                        ) -> Optional[float]:
    """One gradient-MLE experiment (JAX ensemble.py:488-549): fit, GOF,
    profile the signal, write ``{prefix}_mle_{i}.json``, plot.  Returns
    the one-sided profile-likelihood upper limit on the signal of
    interest, or None without a signal_name."""
    result = mle.fit(samples_data)
    log(str(result))
    if gof_toys >= 0:
        from sxmc_tpu_torch.stats.gof import goodness_of_fit

        best_params = np.asarray(
            [result.value(n) for n in mle.parameter_names], np.float32)
        gof = goodness_of_fit(
            fc.sources, fc.signals, fc.systematics, fc.observables,
            samples_data, best_params, ntoys=max(gof_toys, 0), gen=gof_gen,
            stack=mle.stack, refit=True)
        log(f"-- Goodness of fit --\n {gof}")
        if metrics is not None:
            metrics.log("experiment_gof", experiment=index, chi2=gof.chi2,
                        ndof=gof.ndof, p_asymptotic=gof.p_asymptotic,
                        p_toys=gof.p_toys)
    best_fit = result.to_intervals(fc.confidence)
    limit = None
    if fc.signal_name and fc.signal_name in best_fit:
        iv = mle.profile_interval(fc.signal_name, fc.confidence, result)
        best_fit[fc.signal_name] = iv
        limit = mle.upper_limit(fc.signal_name, max(fc.confidence, 0.9),
                                result)
        log(f"ensemble: Signal {fc.signal_name}: {iv}")
        log(f"ensemble: Profile upper limit "
            f"({max(fc.confidence, 0.9):.0%} CL): {limit:g}")
    out = {
        "params": {n: result.value(n) for n in result.names},
        "errors": {n: result.error(n) for n in result.free_names},
        "nll": result.nll,
        "converged": result.converged,
        "upper_limit": limit,
    }
    with open(os.path.join(output_path,
                           f"{fc.output_prefix}_mle_{index}.json"), "w") as f:
        json.dump(out, f, indent=1)
    if fc.plots:
        try:
            from sxmc_tpu_torch import plots

            plots.plot_fit(best_fit, fc, samples_data, output_path,
                           suffix=f"_{index}", formats=fc.plot_formats)
        except Exception as e:  # noqa: BLE001 — never fatal to a fit
            log(f"ensemble: plotting failed: {e}")
    return limit


def main_fit(config_file: str, output_path: str, device="cuda",
             resume: bool = False, data_root: Optional[str] = None,
             max_retries: int = 1,
             binned: Optional[bool] = None,
             rate_substeps: Optional[int] = None,
             sampler: str = "metropolis",
             hypotest_toys: int = 0,
             hypotest_band: bool = False,
             hypotest_asymptotic: bool = False,
             gof_toys: int = -1,
             bias_toys: int = 0) -> List[float]:
    """The whole fit from a config file (reference: sxmc.cpp:181-229);
    ``binned`` and ``rate_substeps``, when given, override
    ``fit.binned`` and ``fit.rate_substeps``; the rest is
    :func:`run_ensemble`'s."""
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
                          max_retries=max_retries, sampler=sampler,
                          hypotest_toys=hypotest_toys,
                          hypotest_band=hypotest_band,
                          hypotest_asymptotic=hypotest_asymptotic,
                          gof_toys=gof_toys, bias_toys=bias_toys)
    if limits:
        print("sxmc_tpu_torch: Upper limits:",
              ", ".join(f"{x:g}" for x in limits))
        print(f"sxmc_tpu_torch: Median upper limit: {median(limits)}")
    else:
        print("sxmc_tpu_torch: Median upper limit: -1")
    return limits
