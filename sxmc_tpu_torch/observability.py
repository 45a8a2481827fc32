"""Step metrics, wall-clock timing, profiling and trace plots.

The port of ``sxmc_tpu/observability.py``: structured JSONL metrics, a
stopwatch (the reference's TStopwatch timing + stderr prints, SURVEY.md
section 5), a ``torch.profiler`` context in place of the
``jax.profiler`` one, and parameter-trace plots from a likelihood space
(the reference's ``bin/time_plot``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import numpy as np


class Stopwatch:
    """Wall-clock timer (reference: TStopwatch usage, mcmc.cpp:259)."""

    def __init__(self):
        self.start()

    def start(self):
        self._t0 = time.perf_counter()

    def real_time(self) -> float:
        return time.perf_counter() - self._t0


class MetricsLogger:
    """Structured JSONL metrics (acceptance rates, step times, ...),
    one JSON object per line appended to ``path``."""

    def __init__(self, path: str):
        self.path = path

    def log(self, event: str, **fields):
        rec = {"event": event, "time": time.time(), **fields}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


@contextlib.contextmanager
def profile(logdir: Optional[str] = None):
    """A ``torch.profiler`` trace of the block, written into ``logdir``
    as a Chrome trace (``trace_<pid>.json``; open it in Perfetto or
    chrome://tracing): host activity, plus CUDA activity where a card is
    present.  Nothing is done when ``logdir`` is None.  A profiler that
    cannot start raises, as ``jax.profiler`` would; it is never skipped
    quietly.  Yields the profiler (or None)."""
    if logdir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = torch_profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir,
                                              f"trace_{os.getpid()}.json"))


def plot_traces(lspace, output_path: str, names=None, suffix: str = ""):
    """Each parameter's value and the NLL against the step, one panel
    each, into ``<output_path>/traces<suffix>.png`` (reference:
    bin/time_plot:1-33); returns the file's path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_path, exist_ok=True)
    names = names or lspace.names
    nrows = len(names) + 1
    fig, axes = plt.subplots(nrows, 1, figsize=(8, 2 * nrows), sharex=True)
    axes = np.atleast_1d(axes)
    for ax, name in zip(axes, names):
        ax.plot(lspace.column(name), lw=0.3)
        ax.set_ylabel(name)
    axes[-1].plot(lspace.nll_values, lw=0.3, color="crimson")
    axes[-1].set_ylabel("NLL")
    axes[-1].set_xlabel("step")
    fig.tight_layout()
    out = os.path.join(output_path, f"traces{suffix}.png")
    fig.savefig(out, dpi=110)
    plt.close(fig)
    return out
