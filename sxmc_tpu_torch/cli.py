"""Command-line interface of the PyTorch port.

``python -m sxmc_tpu_torch.cli fit_configuration.json output_path``
mirrors ``sxmc_tpu.cli`` (reference src/sxmc.cpp:181-187).  The device
is explicit: ``--device cuda`` (the default) runs the hand-written
kernels and raises when CUDA is missing; ``--device cpu`` runs their
plain PyTorch versions.  ``--num-processes N --coordinator host:port
--process-id i`` runs process i of an ensemble spread over N processes
(``parallel.multihost``; ``torch.distributed`` with the gloo backend),
each on ``--device``.
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
                             "fit with profile-likelihood intervals")
    parser.add_argument("--sharded", action="store_true",
                        help="fit every experiment's chains as one batch "
                             "(the experiment-grouped kernels) on the one "
                             "device")
    parser.add_argument("--num-processes", type=int, default=1,
                        metavar="N",
                        help="spread the ensemble over N processes "
                             "(torch.distributed, gloo); each fits its "
                             "block of experiments on --device and writes "
                             "their outputs, process 0 prints the limits")
    parser.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                        help="address of the process group's rendezvous "
                             "(with --num-processes > 1)")
    parser.add_argument("--process-id", type=int, default=None,
                        help="this process's rank in [0, N)")
    parser.add_argument("--profile", metavar="LOGDIR", default=None,
                        help="write a torch.profiler trace (Chrome trace "
                             "format, CUDA activity on the card) of the fit "
                             "into LOGDIR")
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
                        metavar="N",
                        help="checkpoint each chain every N steps so a "
                             "killed fit resumes mid-chain "
                             "({prefix}_chain_{i}.ckpt.npz)")
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

    unsharded = (args.sampler in ("mle", "hmc", "nuts", "stretch",
                                  "tempered")
                 or args.hypotest > 0 or args.hypotest_asymptotic
                 or args.gof_toys >= 0 or args.bias_toys > 0)
    if (args.sharded or args.num_processes > 1) and unsharded:
        raise ValueError(
            "--sharded and --num-processes run the Metropolis fit alone: "
            "--sampler mle|hmc|nuts|stretch|tempered, --hypotest, "
            "--hypotest-asymptotic, --gof and --bias-study run without it")
    device = resolve_device(args.device)
    from sxmc_tpu_torch.observability import profile

    if args.num_processes > 1:
        with profile(args.profile):
            _main_multihost(args, device)
        return 0

    if args.sharded:
        from sxmc_tpu_torch.parallel.ensemble import main_sharded

        with profile(args.profile):
            main_sharded(args.config, args.output_path, device=device,
                         data_root=args.data_root, binned=args.binned,
                         rate_substeps=args.rate_substeps,
                         checkpoint_steps=args.checkpoint_steps,
                         resume=args.resume)
        return 0

    from sxmc_tpu_torch.ensemble import main_fit

    with profile(args.profile):
        main_fit(args.config, args.output_path, device=device,
                 resume=args.resume, data_root=args.data_root,
                 max_retries=args.max_retries, binned=args.binned,
                 rate_substeps=args.rate_substeps, sampler=args.sampler,
                 hypotest_toys=args.hypotest,
                 hypotest_band=args.hypotest_band,
                 hypotest_asymptotic=args.hypotest_asymptotic,
                 gof_toys=args.gof_toys, bias_toys=args.bias_toys,
                 checkpoint_steps=args.checkpoint_steps)
    return 0


def _main_multihost(args, device) -> None:
    """Process ``--process-id`` of ``--num-processes`` (JAX cli.py:
    112-143): join the group, fit this process's block of experiments and
    gather the limits.  Each process writes the likelihood spaces it
    fitted (``<prefix>_<i>.<format>``; the JAX CLI writes process 0's
    only) and a ``multihost_fit`` record to
    ``<prefix>_metrics_<rank>.jsonl`` (its experiments, wall, the gathered
    limits and its kernel launches); process 0 prints the limits."""
    import os

    from sxmc_tpu_torch.fitconfig import FitConfig
    from sxmc_tpu_torch.observability import MetricsLogger, Stopwatch
    from sxmc_tpu_torch.ops import kernels
    from sxmc_tpu_torch.parallel import mesh as mesh_lib
    from sxmc_tpu_torch.parallel.multihost import run_multihost_ensemble
    from sxmc_tpu_torch.utils import median

    mesh_lib.initialize_distributed(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes, process_id=args.process_id)
    fc = FitConfig.from_json_file(args.config, data_root=args.data_root)
    if args.binned:
        fc.binned = True
    if args.rate_substeps is not None:
        fc.rate_substeps = args.rate_substeps
    os.makedirs(args.output_path, exist_ok=True)
    rank, count = mesh_lib.process_index_count()
    sw = Stopwatch()
    lspaces, limits = run_multihost_ensemble(fc, device=device)
    wall = sw.real_time()
    for i, ls in enumerate(lspaces):
        if ls is not None:
            ls.save(os.path.join(args.output_path,
                                 f"{fc.output_prefix}_{i}.{fc.output_format}"))
    MetricsLogger(os.path.join(
        args.output_path, f"{fc.output_prefix}_metrics_{rank}.jsonl")).log(
        "multihost_fit", process=rank, processes=count,
        experiments=[i for i, ls in enumerate(lspaces) if ls is not None],
        wall_seconds=wall, limits=limits.tolist(), device=str(device),
        launches={k: v for k, v in kernels.launch_counts().items() if v})
    if rank == 0:
        print("sxmc_tpu_torch: Upper limits:",
              ", ".join(f"{x!r}" for x in limits.tolist()))
        print(f"sxmc_tpu_torch: Median upper limit: "
              f"{median(list(limits))}")


if __name__ == "__main__":
    sys.exit(main())
