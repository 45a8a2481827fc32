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
                        help="metropolis, or tempered (parallel-tempered "
                             "replica exchange for multimodal posteriors); "
                             "the others are not ported")
    not_ported = {
        "num_processes": "ROADMAP queue A, item 14",
        "coordinator": "ROADMAP queue A, item 14",
        "hypotest": "ROADMAP queue A, item 10",
        "gof": "ROADMAP queue A, item 10",
        "bias_study": "ROADMAP queue A, item 10",
        "checkpoint_steps": "ROADMAP queue A, item 8",
        "profile": "ROADMAP queue A, item 7",
        "process_id": "ROADMAP queue A, item 14",
        "hypotest_band": "ROADMAP queue A, item 10",
        "hypotest_asymptotic": "ROADMAP queue A, item 10",
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
    parser.add_argument("--hypotest", metavar="NTOYS", nargs="?", const=200,
                        type=int, default=0, help="not ported")
    parser.add_argument("--hypotest-band", action="store_true",
                        help="not ported")
    parser.add_argument("--hypotest-asymptotic", action="store_true",
                        help="not ported")
    parser.add_argument("--gof", metavar="NTOYS", nargs="?", const=0,
                        type=int, default=None, help="not ported")
    parser.add_argument("--bias-study", metavar="NTOYS", type=int,
                        default=0, help="not ported")
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

    def requested(key):  # --gof takes an optional count; 0 asks for it too
        v = getattr(args, key)
        if key == "num_processes":
            return v > 1
        if key in ("coordinator", "process_id", "profile"):
            return v is not None
        return v is True or (v is not None and v is not False
                             and (v > 0 or key == "gof"))

    asked = [f"--{k.replace('_', '-')} ({item})"
             for k, item in not_ported.items() if requested(k)]
    if asked:
        raise NotImplementedError(
            "not ported to sxmc_tpu_torch yet: " + "; ".join(asked))
    if args.sampler in ("hmc", "nuts", "stretch", "mle"):
        item = "10" if args.sampler == "mle" else "11"
        raise NotImplementedError(
            f"--sampler {args.sampler} is not ported to sxmc_tpu_torch yet "
            f"(ROADMAP queue A, item {item})")
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
             rate_substeps=args.rate_substeps, sampler=args.sampler)
    return 0


if __name__ == "__main__":
    sys.exit(main())
