"""Command-line interface of the PyTorch port.

``python -m sxmc_tpu_torch.cli fit_configuration.json output_path``
mirrors ``sxmc_tpu.cli`` (reference src/sxmc.cpp:181-187).  The device
is explicit: ``--device cuda`` (the default) runs the hand-written
kernels and raises when CUDA is missing; ``--device cpu`` runs their
plain PyTorch versions.  Options of the JAX CLI that the port does not
run yet are accepted and raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import sys

from sxmc_tpu_torch.utils import resolve_device


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="sxmc_tpu_torch",
        description="Signal extraction with MCMC (PyTorch/CUDA port)")
    parser.add_argument("config", help="fit configuration JSON file")
    parser.add_argument("output_path", help="output directory")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda (hand-written kernels; the default) or "
                             "cpu (their plain PyTorch versions)")
    parser.add_argument("--resume", action="store_true",
                        help="skip experiments with existing outputs")
    parser.add_argument("--data-root", default=None,
                        help="base directory for relative data filenames")
    parser.add_argument("--max-retries", type=int, default=1, metavar="N",
                        help="retry a failed experiment up to N times "
                             "under fresh seeds (default 1)")
    parser.add_argument("--sampler", default="metropolis",
                        choices=["metropolis", "hmc", "nuts", "stretch",
                                 "tempered", "mle"],
                        help="MCMC sampler ('tempered' = parallel-tempered "
                             "replica exchange for multimodal posteriors), "
                             "or 'mle' for a gradient maximum-likelihood "
                             "fit with profile-likelihood intervals; hmc, "
                             "nuts and stretch are not ported")
    not_ported = {
        "num_processes": "ROADMAP queue A, item 14",
        "coordinator": "ROADMAP queue A, item 14",
        "checkpoint_steps": "ROADMAP queue A, item 8",
        "profile": "ROADMAP queue A, item 7",
        "process_id": "ROADMAP queue A, item 14",
    }
    parser.add_argument("--sharded", action="store_true",
                        help="fit every experiment's chains as one batch "
                             "(the experiment-grouped kernels) on the one "
                             "device")
    parser.add_argument("--num-processes", type=int, default=1,
                        metavar="N", help="not ported")
    parser.add_argument("--coordinator", default=None, help="not ported")
    parser.add_argument("--process-id", type=int, default=None,
                        help="not ported")
    parser.add_argument("--profile", metavar="LOGDIR", default=None,
                        help="not ported")
    parser.add_argument("--hypotest", metavar="NTOYS", nargs="?",
                        const=200, type=int, default=0,
                        help="also run frequentist hypothesis tests on "
                             "fit.signal_name: q0 discovery significance "
                             "and a toy-MC CLs upper limit (NTOYS toys "
                             "per grid point, default 200)")
    parser.add_argument("--hypotest-band", action="store_true",
                        help="with --hypotest, also compute the median "
                             "and +-1 sigma expected CLs limits (the "
                             "Brazil band) from background-only toys")
    parser.add_argument("--hypotest-asymptotic", action="store_true",
                        help="compute the asymptotic (Asimov) CLs "
                             "upper limit and expected +-2 sigma band "
                             "for fit.signal_name — deterministic, no "
                             "toys (combine with --hypotest for the "
                             "toy-exact versions too)")
    parser.add_argument("--gof", metavar="NTOYS", nargs="?", const=0,
                        type=int, default=-1, dest="gof_toys",
                        help="report a saturated-chi2 goodness-of-fit "
                             "at each best fit (asymptotic p-value); "
                             "with NTOYS > 0, also an exact "
                             "posterior-predictive p-value from that "
                             "many simulated toys")
    parser.add_argument("--bias-study", metavar="NTOYS", type=int,
                        default=0, dest="bias_toys",
                        help="before fitting, validate the fit with a "
                             "pull/bias study: NTOYS toy experiments "
                             "generated at the nominal rates and fit "
                             "as one batch; reports pull mean/width and "
                             "coverage per free rate (written to "
                             "{prefix}_pulls.json)")
    parser.add_argument("--checkpoint-steps", type=int, default=0,
                        metavar="N", help="not ported")
    parser.add_argument("--rate-substeps", type=int, default=None,
                        metavar="M",
                        help="blocked Metropolis-within-Gibbs: take M "
                             "extra rate-only updates per systematic "
                             "update (each skips the PDF rebuild); "
                             "overrides fit.rate_substeps")
    parser.add_argument("--binned", action="store_true", default=None,
                        help="use the binned likelihood (the exact "
                             "regrouping of the unbinned NLL by dataset "
                             "bin); overrides fit.binned")
    args = parser.parse_args(argv)

    def requested(key):
        v = getattr(args, key)
        if key == "num_processes":
            return v > 1
        if key in ("coordinator", "process_id", "profile"):
            return v is not None
        return v is True or (v is not None and v is not False and v > 0)

    asked = [f"--{k.replace('_', '-')} ({item})"
             for k, item in not_ported.items() if requested(k)]
    if asked:
        raise NotImplementedError(
            "not ported to sxmc_tpu_torch yet: " + "; ".join(asked))
    if args.sampler in ("hmc", "nuts", "stretch"):
        raise NotImplementedError(
            f"--sampler {args.sampler} is not ported to sxmc_tpu_torch yet "
            "(ROADMAP queue A, item 11)")
    tier = (args.sampler == "mle" or args.hypotest > 0
            or args.hypotest_asymptotic or args.gof_toys >= 0
            or args.bias_toys > 0)
    if args.sharded and tier:
        raise ValueError(
            "--sharded runs the Metropolis fit alone: --sampler mle, "
            "--hypotest, --hypotest-asymptotic, --gof and --bias-study "
            "run without it")
    device = resolve_device(args.device)

    if args.sharded:
        from sxmc_tpu_torch.parallel.ensemble import main_sharded

        main_sharded(args.config, args.output_path, device=device,
                     data_root=args.data_root, binned=args.binned,
                     rate_substeps=args.rate_substeps)
        return 0

    from sxmc_tpu_torch.ensemble import main_fit

    main_fit(args.config, args.output_path, device=device,
             resume=args.resume, data_root=args.data_root,
             max_retries=args.max_retries, binned=args.binned,
             rate_substeps=args.rate_substeps, sampler=args.sampler,
             hypotest_toys=args.hypotest, hypotest_band=args.hypotest_band,
             hypotest_asymptotic=args.hypotest_asymptotic,
             gof_toys=args.gof_toys, bias_toys=args.bias_toys)
    return 0


if __name__ == "__main__":
    sys.exit(main())
