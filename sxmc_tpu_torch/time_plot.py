"""Parameter-trace plotting CLI (port of ``sxmc_tpu/time_plot.py``).

The reference's ``bin/time_plot`` script (bin/time_plot:1-33): each
parameter of a saved likelihood space against the MCMC step, and the
NLL below them:

    python -m sxmc_tpu_torch.time_plot lspace_0.npz [outdir] [param ...]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="sxmc_tpu_torch.time_plot",
        description="Plot parameter traces from a saved likelihood space")
    parser.add_argument("lspace", help="saved likelihood-space file "
                                       "(.hdf5/.npz/.csv)")
    parser.add_argument("outdir", nargs="?", default=".",
                        help="output directory (default: cwd)")
    parser.add_argument("params", nargs="*",
                        help="parameters to plot (default: all)")
    args = parser.parse_args(argv)

    from sxmc_tpu_torch.observability import plot_traces
    from sxmc_tpu_torch.stats.likelihood import LikelihoodSpace

    ls = LikelihoodSpace.load(args.lspace)
    out = plot_traces(ls, args.outdir, names=args.params or None)
    print(f"time_plot: wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
