"""Speed of the port's main paths in two checkouts, in turns, on one card.

    python3 bench_turns.py OTHER_CHECKOUT [--json PATH]

from the root of a checkout, on a machine with one Hopper card.  It runs
four fresh processes in this order: OTHER, THIS, THIS, OTHER, each with
that checkout's sxmc_tpu_torch first on sys.path (its kernels built from
its own csrc/ into its own build/), and each measures on the reference
example (chip_smoke.write_example: 2 signals x 500k MC rows), set up
and timed by this checkout's chip_smoke helpers:

  * B4's single-chain diagonal form and its 8-chain batched form: us a
    step of a 500-step ``kernels.fused_segment`` /
    ``fused_segment_batched`` (CUDA events over 10 launches), the
    batched form also at 1,000 energy bins (histograms too large for
    the shared-memory replicas);
  * B5's 8-chain batched form at M = 4 rate moves: us a cycle of a
    500-cycle ``kernels.blocked_segment_batched`` (10 launches);
  * the default path, the 8-chain path and the blocked 8-chain path
    ("rate_substeps": 4) through the CLI (100,000 steps or cycles
    each): chain-steps/s from the ``experiment_fit`` record.

Each run prints one JSON line; ``--json`` also writes them all to a
file.  Compare two versions only within one such call: the card and its
power limit are printed beside the numbers.
"""

import argparse
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parent
FULL_STEPS = 100_000
NCHAINS = 8
RATE_SUBSTEPS = 4


def _smoke():
    """This checkout's chip_smoke (its helpers drive either tree's
    package: they import sxmc_tpu_torch when called)."""
    spec = importlib.util.spec_from_file_location("_turns_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _measure(tree: str) -> dict:
    """One run in this process, with ``tree``'s package."""
    sys.path.insert(0, tree)
    import torch
    import sxmc_tpu_torch

    pkg = pathlib.Path(sxmc_tpu_torch.__file__).resolve()
    if pathlib.Path(tree).resolve() not in pkg.parents:
        raise SystemExit(f"imported {pkg}, not the package of {tree}")
    from sxmc_tpu_torch.cli import main as cli_main
    from sxmc_tpu_torch.ops import kernels

    smoke = _smoke()
    kernels.build()
    out = {"tree": tree}
    with tempfile.TemporaryDirectory() as workdir:
        cfg_path = smoke.write_example(workdir)
        path_1000 = smoke.write_example_variant(cfg_path, workdir, bins=1000)
        mcmcs = {}
        for key, fn, path, nch, sub in (
                ("b4_us_per_step", kernels.fused_segment, cfg_path, 1, ()),
                ("b4_batched_us_per_step", kernels.fused_segment_batched,
                 cfg_path, NCHAINS, ()),
                ("b4_batched_1000_bins_us_per_step",
                 kernels.fused_segment_batched, path_1000, NCHAINS, ()),
                ("b5_batched_us_per_cycle", kernels.blocked_segment_batched,
                 cfg_path, NCHAINS, (RATE_SUBSTEPS + 1,))):
            if path not in mcmcs:
                mcmcs[path] = smoke.example_mcmc(torch, path, workdir)[0]
            args = smoke.segment_args(torch, mcmcs[path], nch, 11, sub)
            ms = smoke.cuda_ms(torch, lambda: fn(*args), 10)
            out[key] = ms / smoke.SEGMENT_STEPS * 1e3

        with open(cfg_path) as f:
            cfg = json.load(f)
        for tag, nch, m in (("default", 1, 0), ("nchains=8", NCHAINS, 0),
                            ("rate_substeps=4, nchains=8", NCHAINS,
                             RATE_SUBSTEPS)):
            cfg["fit"].update(nsteps=FULL_STEPS, nchains=nch,
                              rate_substeps=m)
            path = os.path.join(workdir, f"turns_{nch}_{m}.json")
            with open(path, "w") as f:
                json.dump(cfg, f)
            res = os.path.join(workdir, f"out_{nch}_{m}")
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
