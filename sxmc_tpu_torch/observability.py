"""Step metrics and wall-clock timing.

The port of ``sxmc_tpu/observability.py``: structured JSONL metrics
and a stopwatch (the reference's TStopwatch timing + stderr prints,
SURVEY.md section 5).  The jax.profiler context has no counterpart
here yet; ``torch.profiler`` is the tool for a device trace.
"""

from __future__ import annotations

import json
import time


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
