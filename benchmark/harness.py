"""One run of one cell: set-up, the measured window, the comparison.

Everything that belongs to a configuration, a traffic mix or a per-layer
metric is data found by name: ``BENCHMARK.json`` names the cell, its
configuration file and its traffic; the traffic is
``benchmark/workloads/<traffic>.json``; the limits of the comparison are
``benchmark/limits/<cell>.json``; a per-layer metric is read by
``benchmark/metrics/<metric>.py``'s ``read(ctx)``.

The traffic's ``loop`` names the closed loop, ``benchmark/loops/<loop>.py``
(``fit``: fits back to back on one dataset): its ``Loop`` warms up, runs
one unit at a time, reports its end-to-end metrics and judges its units
against the reference.

The window ends at the first unit boundary at or after ``seconds``; the
rates count every unit completed in it over its whole time.
"""

from __future__ import annotations

import copy
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from benchmark import compare, reference, roofline, tables
from benchmark.trace import Trace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sxmc_tpu")
WARM_STEPS = 300


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_spec(name: str, man: Optional[dict] = None) -> dict:
    """The cell, its configuration, traffic and limits, by name."""
    man = man or manifest()
    cell = next(w for w in man["workloads"] if w["name"] == name)
    conf = next(c for c in man["configs"] if c["name"] == cell["config"])
    with open(ROOT / conf["file"]) as f:
        cfg = json.load(f)
    with open(BENCH / "workloads" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    with open(BENCH / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    return dict(cell=cell, cfg=cfg, traffic=traffic, limits=limits,
                manifest=man)


def shrink(cfg: dict, rows: int, nsteps: int) -> dict:
    """A copy of ``cfg`` with ``rows`` MC rows a signal and ``nsteps``
    steps: the size a CPU test can hold."""
    cfg = copy.deepcopy(cfg)
    for t in cfg["tables"].values():
        t["rows"] = rows
    cfg["sxmc"]["fit"]["nsteps"] = nsteps
    return cfg


# ----------------------------------------------------------- the program


def program_config(cfg: dict, host_tables: Dict[str, tuple], seed: int,
                   nexperiments: int = 1, nchains: int = 1):
    """The program's ``FitConfig`` of ``cfg`` with its signals built from
    the tables in memory (``Signal.from_table``), as ``FitConfig.from_dict``
    builds them from files."""
    from sxmc_tpu_torch.fitconfig import FitConfig
    from sxmc_tpu_torch.signal import Signal

    sx = copy.deepcopy(cfg["sxmc"])
    active = list(sx["fit"]["signals"])
    sx["fit"].update(signals=[], nexperiments=nexperiments, nchains=nchains,
                     seed=seed, plots=False)
    fc = FitConfig.from_dict(sx)
    for name in active:
        conf = sx["signals"][name]
        data, fields = host_tables[name]
        nexp = (float(conf["rate"]) if "rate" in conf
                else -1.0 / float(conf["scale"]))
        fc.signals.append(Signal.from_table(
            name, conf.get("title", name), data, fields,
            int(conf["dataset"]),
            next(s for s in fc.sources if s.name == conf.get("source", name)),
            nexp, fc.sample_fields, fc.observables, fc.cuts,
            [s for s in fc.systematics
             if s.name in conf.get("systematics", [])]))
    fc.datasets = sorted({s.dataset for s in fc.signals})
    return fc


def to_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x



# -------------------------------------------------------------- the run


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def setup(spec: dict, seed: int, device, marks: Dict[str, float]):
    """Tables on the device, the program's host containers, the traffic's
    loop (``benchmark/loops/<loop>.py``) and its warm-up; ``marks`` gets
    the host clock at the end of each part."""
    dev_tables = tables.mc_tables(spec["cfg"], seed, device)
    _sync(device)
    marks["tables"] = time.perf_counter()
    host = {k: (to_numpy(v[0]), v[1]) for k, v in dev_tables.items()}
    name = spec["traffic"]["loop"]
    mod = load_module(BENCH / "loops" / f"{name}.py",
                      f"benchmark_loop_{name}")
    loop = mod.Loop(spec, seed, device, host)
    _sync(device)
    marks["program"] = time.perf_counter()
    loop.warmup(dev_tables)
    _sync(device)
    marks["warmup"] = time.perf_counter()
    return loop, dev_tables


def window(loop, seconds: float, device, traced: bool, tmp: str):
    """Units back to back until ``seconds`` have passed; returns the
    window's seconds, the work done and the trace (when ``traced``)."""
    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    work, units = 0, 0
    t0 = time.perf_counter()
    with torch.profiler.record_function("bench.window"):
        while True:
            work += loop.unit(units)
            units += 1
            _sync(device)
            if time.perf_counter() - t0 >= seconds:
                break
    elapsed = time.perf_counter() - t0
    trace = None
    if prof is not None:
        prof.__exit__(None, None, None)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        trace = Trace.load(path)
        os.remove(path)
    return elapsed, work, units, trace


def load_readers(spec: dict, traced: bool) -> Dict[str, object]:
    """The cell's metric readers: ``benchmark/metrics/<name>.py`` of each
    per-layer metric that lists the cell (or lists none)."""
    if not traced:
        return {}
    name = spec["cell"]["name"]
    out = {}
    for m in spec["manifest"]["per_layer"]:
        if name not in m.get("workloads", [name]):
            continue
        mod = load_module(BENCH / "metrics" / f"{m['name']}.py",
                          f"benchmark_metric_{len(out)}")
        out[m["name"]] = (mod, m["unit"])
    return out


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in sys.modules
                   if n.split(".")[0] in FORBIDDEN})


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             t_start: float, device="cuda", spec: Optional[dict] = None,
             judge_control: bool = False) -> dict:
    """One run of ``workload``: returns the result line's object, or
    raises.  ``spec`` replaces the cell's files (tests); with
    ``judge_control`` the comparison also reads the control."""
    spec = spec or cell_spec(workload)
    cell, traffic = spec["cell"], spec["traffic"]
    dev = torch.device(device)
    tmp = tempfile.mkdtemp(prefix="sxmc_bench_run_")
    marks = {"start": time.perf_counter()}
    torch.empty(1, device=dev)
    _sync(dev)
    marks["context"] = time.perf_counter()
    loop, dev_tables = setup(spec, seed, dev, marks)
    setup_s = time.perf_counter() - t_start
    elapsed, work, units, trace = window(loop, seconds, dev, traced, tmp)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    loop.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    model = reference.Model(loop.layout, dev_tables, dev)
    readers = load_readers(spec, traced)
    ctx = _context(spec, loop, trace, model) if traced else None
    k = int(traffic["check_steps"])
    readings = loop.judge(model, k)
    limits = {n: float(spec["limits"][n]) for n in compare.NAMES}
    correct = compare.verdict(readings, limits)
    control = None
    if judge_control:
        cmodel = reference.Model(loop.layout, dev_tables, dev,
                                 dtype=torch.bfloat16)
        control = loop.judge(model, k, control=cmodel)

    metrics = {}
    if not traced:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        metrics.update(loop.end_to_end(elapsed, units, work))
    else:
        for name, (mod, unit) in readers.items():
            v = mod.read(ctx)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": unit}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": units, "failed": 0,
              "metrics": metrics, "device": device_info}
    if traced and ctx is not None:
        w0, w1 = ctx.window
        busy = sum(b - a for a, b in ctx.trace.busy(w0, w1)) * 1e-6
        device_info["busy_s"] = busy
        device_info["window_s"] = (w1 - w0) * 1e-6
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(w0, w1),
                               "idle_gaps": ctx.trace.idle_gaps(w0, w1)}
    shutil.rmtree(tmp, ignore_errors=True)
    result["checks"] = compare.checks_line(readings, limits)
    # Set-up by part: the interpreter and imports, the card's context, the
    # tables, the program's containers, the warm-up.
    parts = ("imports", "context", "tables", "program", "warmup")
    times = [t_start] + list(marks.values())
    split = {p: b - a for p, a, b in zip(parts, times[:-1], times[1:])}
    extra = dict(window_s=elapsed, units=units, work=work,
                 unit_walls=loop.walls, setup_split=split)
    if control is not None:
        extra["control"] = compare.checks_line(control, limits)
    return dict(result=result, extra=extra)


class Context:
    """What a per-layer metric reader gets: the trace, the window, the
    spans of the cell's units and the work each does, and the least time
    of one step."""


def _context(spec, loop, trace: Optional[Trace], model):
    ctx = Context()
    ctx.trace = trace
    ctx.window = trace.window() if trace is not None else None
    ctx.unit_span = loop.span
    ctx.units = trace.spans.get(loop.span, []) if trace is not None else []
    ctx.nsteps = loop.nsteps
    ctx.nchains = loop.nchains
    byts, flops = roofline.step_work(model, loop.step_events(model),
                                     loop.nchains)
    ctx.step_bytes, ctx.step_flops = byts, flops
    ctx.least_s_per_step = roofline.least_seconds(byts, flops)
    return ctx
