"""Reading a ``torch.profiler`` Chrome trace of the measured window.

Device activity is every event of category ``kernel``, ``gpu_memcpy`` or
``gpu_memset``; spans are the ``user_annotation`` events that the
benchmark's own ``record_function`` blocks leave around its calls into the
program.  Times are microseconds on the trace's one clock.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def short_name(name: str) -> str:
    """A kernel's name without its argument list."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i].rstrip() or name
    return name


class Trace:
    def __init__(self, events: List[dict]):
        self.kernels: List[Tuple[float, float, str]] = []
        self.device: List[Tuple[float, float, str]] = []
        self.spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self.cpu_ops: List[Tuple[float, float, str]] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            name = e.get("name", "")
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, name))
                if cat == "kernel":
                    self.kernels.append((ts, ts + dur, name))
            elif cat == "user_annotation":
                self.spans[name].append((ts, ts + dur))
            elif cat == "cpu_op":
                self.cpu_ops.append((ts, ts + dur, name))
        self.device.sort()
        self.kernels.sort()
        self.cpu_ops.sort()

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []))

    def window(self, name: str = "bench.window") -> Optional[Tuple]:
        s = self.spans.get(name)
        return s[0] if s else None

    def busy(self, a: float, b: float, events=None) -> List[Tuple]:
        """Merged device intervals clipped to ``[a, b]``."""
        merged: List[List[float]] = []
        for s, e, _ in (self.device if events is None else events):
            s, e = max(s, a), min(e, b)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(m) for m in merged]

    def kernels_in(self, spans) -> List[Tuple[float, float, str]]:
        """Kernels that start inside any of ``spans``."""
        return [k for k in self.kernels
                if any(a <= k[0] <= b for a, b in spans)]

    def top_ops(self, a: float, b: float, n: int = 10) -> List[list]:
        tot: Dict[str, float] = defaultdict(float)
        for s, e, name in self.device:
            s, e = max(s, a), min(e, b)
            if e > s:
                tot[short_name(name)] += (e - s) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda x: -x[1])
                [:n]]

    def idle_gaps(self, a: float, b: float, n: int = 10) -> List[list]:
        """The ``n`` longest spells in ``[a, b]`` with no device activity,
        each named by the innermost benchmark span and the torch operation
        that the host was in at its middle."""
        gaps = []
        t = a
        for s, e in self.busy(a, b) + [(b, b)]:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = 0.5 * (s + e)
            span = min(((y - x, name) for name, lst in self.spans.items()
                        for x, y in lst if x <= mid <= y),
                       default=(0, "outside spans"))[1]
            op = max(((y - x, name) for x, y, name in self.cpu_ops
                      if x <= mid <= y), default=(0, "no torch op"))[1]
            out.append([f"{span} / {op}", (e - s) * 1e-6])
        return out
