"""Readings of the comparison for the program and for its control.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 \
        [--seconds S] [--json out.jsonl]

For each seed, in one process, runs the cell as ``run.py`` does (at its
sizes, a window of ``S`` seconds, by default the manifest's
``run_seconds``) and prints one JSON line: the program's reading of every
number compared, and the control's, the reference computed in bfloat16 put
in the program's place on the same states and streams.  The limits in
``benchmark/limits/<cell>.json`` were set from such readings; the
benchmark's own runs never run the control.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    spec = harness.cell_spec(args.workload)
    seconds = args.seconds or spec["manifest"]["run_seconds"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = harness.run_cell(args.workload, seed, seconds, False, t,
                               device="cuda:0", spec=spec,
                               judge_control=True)
        line = {"workload": args.workload, "seed": seed,
                "correct": out["result"]["correct"],
                "program": out["result"]["checks"],
                "control": out["extra"]["control"],
                "units": out["extra"]["units"]}
        print(json.dumps(line), flush=True)
        if args.json:
            with open(args.json, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
