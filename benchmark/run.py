"""Run one cell of the benchmark of ``sxmc_tpu_torch`` on an H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints progress and the numbers compared to
standard error, and as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device`` (with
``busy_s`` and ``window_s`` when traced), ``breakdown`` when traced, and
``checks`` (each number compared, with its limit) last.  Exits non-zero,
printing no result, without a card, or when the process holds a module of
the JAX package or of JAX once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    spec = harness.cell_spec(args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), T_START, device="cuda:0",
                           spec=spec)
    # Read after the run: nvidia-smi takes seconds, which set-up must not.
    print(f"benchmark: {args.workload} seed {args.seed} on "
          f"{power_limit()}", file=sys.stderr)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: the process holds {bad}; the port must not load "
              "JAX or the JAX package", file=sys.stderr)
        return 3
    res = out["result"]
    print("benchmark: " + json.dumps(out["extra"]), file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"n {c['n']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
