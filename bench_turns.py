"""Speed of the port's main paths in two checkouts, in turns, on one card.

    python3 bench_turns.py OTHER_CHECKOUT [--json PATH]

from the root of a checkout, on a machine with one Hopper card.  It runs
four fresh processes in this order: OTHER, THIS, THIS, OTHER, each with
that checkout's sxmc_tpu_torch first on sys.path (its kernels built from
its own csrc/ into its own build/), and each measures on the reference
example (chip_smoke.write_example: 2 signals x 500k MC rows):

  * B4's single-chain diagonal form: us/step of a 500-step
    ``kernels.fused_segment`` (CUDA events over 10 launches);
  * the default path and the 8-chain path through the CLI (100,000
    steps each): chain-steps/s from the ``experiment_fit`` record.

Each run prints one JSON line; ``--json`` also writes them all to a
file.  Compare two versions only within one such call: the card and its
power limit are printed beside the numbers.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parent
SEGMENT_STEPS = 500
FULL_STEPS = 100_000
NCHAINS = 8


def _measure(tree: str) -> dict:
    """One run in this process, with ``tree``'s package."""
    sys.path.insert(0, tree)
    import torch
    import sxmc_tpu_torch
    from chip_smoke import write_example

    pkg = pathlib.Path(sxmc_tpu_torch.__file__).resolve()
    if pathlib.Path(tree).resolve() not in pkg.parents:
        raise SystemExit(f"imported {pkg}, not the package of {tree}")
    from sxmc_tpu_torch.cli import main as cli_main
    from sxmc_tpu_torch.fitconfig import FitConfig
    from sxmc_tpu_torch.generator import make_fake_dataset
    from sxmc_tpu_torch.mcmc.metropolis import MCMC, initial_state
    from sxmc_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    kernels.build()
    out = {"tree": tree}
    with tempfile.TemporaryDirectory() as workdir:
        cfg_path = write_example(workdir)
        fc = FitConfig.from_json_file(cfg_path, data_root=workdir)
        mcmc = MCMC(fc.sources, fc.signals, fc.systematics, fc.observables,
                    device=dev)
        st = mcmc.stack
        st.set_data(make_fake_dataset(torch.Generator().manual_seed(3),
                                      fc.signals, fc.systematics,
                                      fc.observables, stack=st))
        params, nll0, width = initial_state(mcmc, st.read_bins)
        gen = torch.Generator(dev).manual_seed(11)
        noise = torch.randn((SEGMENT_STEPS, mcmc.nparameters),
                            generator=gen, device=dev)
        log_u = torch.log(torch.rand(SEGMENT_STEPS, generator=gen,
                                     device=dev))
        args = (st.hist_spec, mcmc.nll_spec, st.samples, st.hist_init,
                st.read_bins, params, torch.stack(nll0), width, noise, log_u)
        kernels.fused_segment(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            kernels.fused_segment(*args)
        stop.record()
        torch.cuda.synchronize()
        out["b4_us_per_step"] = (start.elapsed_time(stop) / 10
                                 / SEGMENT_STEPS * 1e3)

        with open(cfg_path) as f:
            cfg = json.load(f)
        for tag, nch in (("default", 1), ("nchains=8", NCHAINS)):
            cfg["fit"].update(nsteps=FULL_STEPS, nchains=nch)
            path = os.path.join(workdir, f"turns_{nch}.json")
            with open(path, "w") as f:
                json.dump(cfg, f)
            res = os.path.join(workdir, f"out_{nch}")
            rc = cli_main([path, res, "--data-root", workdir, "--device",
                           "cuda", "--max-retries", "0"])
            with open(os.path.join(res, "example_metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            fit = [r for r in recs if r["event"] == "experiment_fit"]
            if rc != 0 or len(fit) != 1:
                raise SystemExit(f"{tag}: cli returned {rc}, {recs}")
            out[f"{tag} chain-steps/s"] = fit[0]["steps_per_sec"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", help="the other checkout's root")
    ap.add_argument("--json", help="also write the runs to this file")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print("TURN " + json.dumps(_measure(args.measure)), flush=True)
        return 0
    if not args.other:
        ap.error("give the other checkout's root")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_turns: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    runs = []
    for tree in (args.other, str(HERE), str(HERE), args.other):
        proc = subprocess.run(
            [sys.executable, str(HERE / "bench_turns.py"), "--measure",
             str(pathlib.Path(tree).resolve())],
            capture_output=True, text=True, cwd=str(HERE))
        line = [x for x in proc.stdout.splitlines() if x.startswith("TURN ")]
        if proc.returncode != 0 or not line:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise SystemExit(f"bench_turns: the run of {tree} failed")
        run = dict(json.loads(line[0][5:]), card=smi)
        runs.append(run)
        print(json.dumps(run), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(runs, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
