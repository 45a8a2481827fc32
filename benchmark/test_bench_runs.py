"""Whole runs of each cell at a size the CPU holds, with the program's
plain PyTorch path: a sound run comes out correct; the bfloat16 control
does not; nor does a run whose timed path is broken underneath (a chain
that keeps its state, half of the events left out and the rest counted
twice, an answer altered where it is produced).

The card test runs ``benchmark/run.py`` itself for a few seconds.

    python -m pytest benchmark/ -q            # CPU; -m cuda on the card
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import compare, harness

ROOT = Path(__file__).resolve().parent.parent
CELLS = ["pdfz.fit", "example.fit"]
SIZES = {"pdfz.fit": (200000, 4000), "example.fit": (4000, 400)}


def run(cell: str, seed: int = 1234567890123, control: bool = False):
    torch.set_num_threads(2)
    spec = harness.cell_spec(cell)
    spec["cfg"] = harness.shrink(spec["cfg"], *SIZES[cell])
    return harness.run_cell(cell, seed, 0.5, False, time.perf_counter(),
                            device="cpu", spec=spec, judge_control=control)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_control_is_not(cell):
    out = run(cell, control=True)
    res = out["result"]
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    limits = {k: v["limit"] for k, v in res["checks"].items()}
    control = compare.Readings()
    for k, v in out["extra"]["control"].items():
        control.add(k, v["value"])
    assert not compare.verdict(control, limits)
    assert set(res["metrics"]) == {"setup_s", "chain_steps_per_s"}


def _frozen(fn):
    def wrapped(spec, ns, samples, hist_init, rb, params0, nll0, width,
                noise, log_u, debug_mode):
        s, n, a = fn(spec, ns, samples, hist_init, rb, params0, nll0, width,
                     noise, log_u, debug_mode)
        s = params0.expand_as(s).clone()
        return s, nll0.to(n.dtype).expand_as(n).clone(), torch.zeros_like(a)
    return wrapped


def _altered(fn):
    def wrapped(*args):
        s, n, a = fn(*args)
        s = s.clone()
        s[..., 0] = s[..., 0] * 1.001
        return s, n, a
    return wrapped


def _half_events(fn):
    def wrapped(self, data):
        d = np.array(data, copy=True)
        n = d.shape[-2]
        half = n // 2
        d[..., half:2 * half, :] = d[..., :half, :]
        return fn(self, d)
    return wrapped


FAULTS = ["state_unchanged", "half_events", "state_altered", "limit_altered"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    from sxmc_tpu_torch.ops import kernels
    from sxmc_tpu_torch.pdf.stack import PdfStack
    from sxmc_tpu_torch.stats import intervals

    names = ("fused_segment", "fused_segment_batched")
    if fault in ("state_unchanged", "state_altered"):
        wrap = _frozen if fault == "state_unchanged" else _altered
        for n in names:
            monkeypatch.setattr(kernels, n, wrap(getattr(kernels, n)))
    elif fault == "half_events":
        monkeypatch.setattr(PdfStack, "compute_read_bins",
                            _half_events(PdfStack.compute_read_bins))
    else:
        get = intervals.Contour.get_interval

        def altered(self, name):
            iv = get(self, name)
            iv.upper = iv.upper * (1.0 + 1e-6)
            return iv
        monkeypatch.setattr(intervals.Contour, "get_interval", altered)
    res = run(cell)["result"]
    assert not res["correct"], res["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_run_on_the_card(card, cell):
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "9876543210", "--seconds", "2", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, BENCH_RUN="test"))
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0 and res["metrics"]
