"""Speed of the port's main paths in two checkouts, in turns, on one card.

    python3 bench_turns.py OTHER_CHECKOUT [--json PATH] [--skip-turns]
        [--binned ROUNDS] [--b2 ROUNDS]

from the root of a checkout, on a machine with one Hopper card.  It runs
four fresh processes in this order: OTHER, THIS, THIS, OTHER, each with
that checkout's sxmc_tpu_torch first on sys.path (its kernels built from
its own csrc/ into its own build/), and each measures on the reference
example (chip_smoke.write_example: 2 signals x 500k MC rows), set up
and timed by this checkout's chip_smoke helpers:

  * B1 in every form, at the shapes of PERF.md's table: one theta (the
    example's 2 x 500k rows, 10 bins, scale and resolution; and 10M rows
    x 1,000 bins, one shift), 8 chains on the example, the weighted
    forms of the three, and B1a (EvalHist.histogram on signal1's 500k
    rows): ms a call with calls back to back (CUDA events over 50
    calls) and on the card (torch.profiler: the B1 kernels' time a
    call), and the device operations a call shows (kernels and
    memsets);
  * B4's single-chain diagonal form and its 8-chain batched form: us a
    step of a 500-step ``kernels.fused_segment`` /
    ``fused_segment_batched`` (CUDA events over 10 launches), the
    batched form also at 1,000 energy bins (histograms too large for
    the shared-memory replicas);
  * B5's 8-chain batched form at M = 4 rate moves: us a cycle of a
    500-cycle ``kernels.blocked_segment_batched`` (10 launches);
  * the default path, the 8-chain path and the blocked 8-chain path
    ("rate_substeps": 4) through the CLI (100,000 steps or cycles
    each), and the binned 8-chain path (--binned, 8,000 steps: B1-
    batched every step): chain-steps/s from the ``experiment_fit``
    record.

Then, in one more process of THIS checkout, B1's probe:

  * every B1 form (not B1a) on the grid and slots of the port's rule
    (``sx_hist_grid``) and at 1, 2, 3 and 4 blocks per SM and other slot
    counts: card ms, each checked against the plain version;
  * the split of each form on the rule's grid, by composition: full;
    loads only (the same rows, every one out of domain: no atomic and
    nothing to flush); no rows (the fixed cost: clearing the slots, the
    flush's reads, the ticket and the last block's pass);

and, of both checkouts' libraries, the SASS instructions of every B1
kernel (``cuobjdump -sass``: the whole function, and the span from its
first global load to its last shared atomic, the row loop) and ptxas's
registers and spills of every kernel, with any spill that THIS has and
OTHER has not.

Each run prints one JSON line; ``--json`` also writes them all to a
file.  ``--skip-turns`` runs only the probe and the library reports.
``--binned ROUNDS`` runs only the binned 8-chain path's study, in ROUNDS
rounds of the four turns: its chain-steps/s, the host's time to issue
one B1-batched call, and a torch.profiler trace of a 1,000-step fit (the
step period on the card's clock, busy time and idle share, device
operations a step; see ``_measure_binned``).
``--b2 ROUNDS`` runs only B2's study, in ROUNDS rounds of the four
turns: at each shape of ``chip_smoke.b2_cases`` (the example's LUT, 8
chains x 2 signals on its 2 read-bin rows, 2 x 1M events x 1,000 bins,
16 rows on 2 at that size, rows of 60,000 bins), ``chip_smoke.
b2_measure``'s numbers: ms a call back to back (CUDA events; through the
read bins' plan where the tree has plans, and through ``lut_eval``),
card ms (torch.profiler), the plain version's ms, torch.gather's ms
and card ms, and the bound.
Compare two versions only within one such call: the card and its power
limit are printed beside the numbers.
"""

import argparse
import importlib.util
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parent
FULL_STEPS = 100_000
LOOP_STEPS = 8_000
TRACE_STEPS = 1_000
NCHAINS = 8
RATE_SUBSTEPS = 4
B1_REPS = 50
# The kernels of a B1 call, in either checkout.
B1_NAMES = ("sx_hist_kernel", "sx_to_float")


def _smoke():
    """This checkout's chip_smoke (its helpers drive either tree's
    package: they import sxmc_tpu_torch when called)."""
    spec = importlib.util.spec_from_file_location("_turns_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _import_tree(tree: str):
    sys.path.insert(0, tree)
    import sxmc_tpu_torch

    pkg = pathlib.Path(sxmc_tpu_torch.__file__).resolve()
    if pathlib.Path(tree).resolve() not in pkg.parents:
        raise SystemExit(f"imported {pkg}, not the package of {tree}")


def b1_cases(torch, kernels, smoke, cfg_path: str, workdir: str) -> dict:
    """The B1 forms of PERF.md's table: name -> (HistSpec, samples,
    theta, call).  ``call()`` runs the form as the port calls it; theta
    is (npar,) for one theta, (NCHAINS, npar) for a batch."""
    from sxmc_tpu_torch.fitconfig import FitConfig
    from sxmc_tpu_torch.mcmc.metropolis import MCMC
    from sxmc_tpu_torch.ops.transforms import SHIFT, SystematicDesc
    from sxmc_tpu_torch.pdf.evalhist import EvalHist
    from sxmc_tpu_torch.signal import nominal_params

    dev = torch.device("cuda")
    cases = {}

    def add(name, hs, x, th):
        fn = (kernels.segmented_histogram if th.dim() == 1
              else kernels.segmented_histogram_batched)
        cases[name] = (hs, x, th, lambda: fn(hs, x, th))

    for weighted in (False, True):
        w = "_weighted" if weighted else ""
        fc = (smoke.weighted_fit(cfg_path, workdir) if weighted else
              FitConfig.from_json_file(cfg_path, data_root=workdir))
        st = MCMC(fc.sources, fc.signals, fc.systematics, fc.observables,
                  device=dev).stack
        theta = torch.as_tensor(nominal_params(fc.systematics), device=dev)
        gen = torch.Generator(dev).manual_seed(5)
        thetas = theta + 0.01 * torch.randn((NCHAINS, theta.shape[0]),
                                            generator=gen, device=dev)
        add("b1" + w, st.hist_spec, st.samples, theta)
        n = 10_000_000
        gen = torch.Generator(dev).manual_seed(7)
        rows = [torch.rand((1, n), generator=gen, device=dev) * 12.0 + 4.0]
        if weighted:
            rows.append(torch.exp(smoke.WEIGHT_SIGMA * torch.randn(
                (1, n), generator=gen, device=dev)))
        hs10 = kernels.HistSpec.build(
            1, [5.0], [15.0], [1000],
            [(SystematicDesc(type=SHIFT, obs=0, par_indices=(0,)),
              (True,))], [0, n], weighted=weighted)
        add("b1_10m" + w, hs10, torch.cat(rows),
            torch.as_tensor([0.0137], device=dev))
        add("b1_batched" + w, st.hist_spec, st.samples, thetas)
        if not weighted:
            sig = fc.signals[0].histogram
            ev = EvalHist(sig.samples_host, sig.nfields, sig.nobservables,
                          sig.lower_host, sig.upper_host, sig.nbins,
                          dataset=sig.dataset, device=dev)
            for d in sig.systematics:
                ev.add_systematic(d)
            ev_theta = [0.004, -0.0007]
            cases["b1a"] = (ev.hist_spec(), ev.device_samples(),
                            torch.as_tensor(ev_theta, device=dev),
                            lambda: ev.histogram(ev_theta))
    return cases


def device_ops(torch, fn, reps: int = 5) -> float:
    """Device operations (kernels and memsets) a call of ``fn`` shows in
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # A first profile, discarded: once, the first profile taken in a
    # process reported 800 operations a call.
    with profile(activities=[ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.device_type.name == "CUDA"
           and ("memset" in e.name.lower() or "sx_" in e.name)]
    return len(ops) / reps


def _measure(tree: str) -> dict:
    """One run in this process, with ``tree``'s package."""
    _import_tree(tree)
    import torch
    from sxmc_tpu_torch.cli import main as cli_main
    from sxmc_tpu_torch.ops import kernels

    smoke = _smoke()
    kernels.build()
    out = {"tree": tree}
    with tempfile.TemporaryDirectory() as workdir:
        cfg_path = smoke.write_example(workdir)
        for name, (_, _, _, call) in b1_cases(torch, kernels, smoke,
                                               cfg_path, workdir).items():
            out[f"{name} ms"] = smoke.cuda_ms(torch, call, B1_REPS)
            out[f"{name} card ms"] = smoke.device_ms(torch, call, B1_REPS,
                                                     B1_NAMES)
            out[f"{name} device ops"] = device_ops(torch, call)
        torch.cuda.empty_cache()
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

        for tag, nch, m, nsteps, flags in (
                ("default", 1, 0, FULL_STEPS, []),
                ("nchains=8", NCHAINS, 0, FULL_STEPS, []),
                ("rate_substeps=4, nchains=8", NCHAINS, RATE_SUBSTEPS,
                 FULL_STEPS, []),
                ("binned, nchains=8", NCHAINS, 0, LOOP_STEPS,
                 ["--binned"])):
            out[f"{tag} chain-steps/s"] = _cli_rate(
                cli_main, cfg_path, workdir, nch, m, nsteps, flags)
    return out


def _cli_rate(cli_main, cfg_path: str, workdir: str, nch: int, m: int,
              nsteps: int, flags: list) -> float:
    """Chain-steps/s of one CLI fit of the example at ``nch`` chains,
    ``m`` rate substeps and ``nsteps`` steps (the experiment_fit
    record)."""
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["fit"].update(nsteps=nsteps, nchains=nch, rate_substeps=m)
    name = f"turns_{nch}_{m}_{len(flags)}_{nsteps}"
    path = os.path.join(workdir, name + ".json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    res = os.path.join(workdir, name)
    rc = cli_main([path, res, "--data-root", workdir, "--device", "cuda",
                   "--max-retries", "0"] + flags)
    with open(os.path.join(res, "example_metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    fit = [r for r in recs if r["event"] == "experiment_fit"]
    if rc != 0 or len(fit) != 1:
        raise SystemExit(f"{name}: cli returned {rc}, {recs}")
    return fit[0]["steps_per_sec"]


def _measure_binned(tree: str) -> dict:
    """The binned 8-chain path alone, in this process with ``tree``'s
    package: its chain-steps/s (LOOP_STEPS steps through the CLI); the
    host's microseconds to issue one B1-batched call at the path's shape
    (calls back to back, no synchronisation between them); and, over a
    TRACE_STEPS-step fit under torch.profiler (the card's activity
    only), on the card's clock between B1 launches (the last 90% of
    them, past the set-up's): the
    step period, the card's busy time a step (the union of its kernels,
    memsets and copies), its idle share, its device operations a step
    and B1's time a launch."""
    _import_tree(tree)
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from sxmc_tpu_torch.cli import main as cli_main
    from sxmc_tpu_torch.ops import kernels

    smoke = _smoke()
    kernels.build()
    out = {"tree": tree}
    with tempfile.TemporaryDirectory() as workdir:
        cfg_path = smoke.write_example(workdir)
        call = b1_cases(torch, kernels, smoke, cfg_path,
                        workdir)["b1_batched"][3]
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            call()
        out["B1-batched host us a call"] = (time.perf_counter() - t0) / 200e-6
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out["binned, nchains=8 chain-steps/s"] = _cli_rate(
            cli_main, cfg_path, workdir, NCHAINS, 0, LOOP_STEPS, ["--binned"])
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out["trace chain-steps/s"] = _cli_rate(
                cli_main, cfg_path, workdir, NCHAINS, 0, TRACE_STEPS,
                ["--binned"])
        trace = os.path.join(workdir, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            evs = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    e.get("name", "")) for e in evs
                   if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy"))
    b1 = [sp for sp in spans if "sx_hist_kernel" in sp[2]]
    out["trace B1 launches"] = len(b1)
    b1 = b1[len(b1) // 10:]  # past the set-up's launches
    lo, hi = b1[0][0], b1[-1][0]
    steps = len(b1) - 1
    busy, end = 0.0, lo
    nops = 0
    for a, b, _ in spans:
        if lo <= a < hi:
            nops += 1
            b = min(b, hi)
            if b > end:
                busy += b - max(a, end)
                end = b
    out.update({"trace step us": (hi - lo) / steps,
                "trace busy us a step": busy / steps,
                "trace idle share": 1.0 - busy / (hi - lo),
                "trace device ops a step": nops / steps,
                "trace B1 card us": sum(b - a for a, b, _ in b1) / len(b1)})
    return out


def _measure_b2(tree: str) -> dict:
    """B2's shapes in this process, with ``tree``'s package (see the
    module docstring)."""
    _import_tree(tree)
    import torch
    from sxmc_tpu_torch.ops import kernels
    from sxmc_tpu_torch.signal import nominal_params

    smoke = _smoke()
    kernels.build()
    dev = torch.device("cuda")
    out = {"tree": tree}
    with tempfile.TemporaryDirectory() as workdir:
        cfg_path = smoke.write_example(workdir)
        mcmc, _ = smoke.example_mcmc(torch, cfg_path, workdir)
        st = mcmc.stack
        theta = torch.as_tensor(nominal_params(mcmc.systematics),
                                device=dev)
        gen = torch.Generator(dev).manual_seed(5)
        thetas = theta + 0.01 * torch.randn((NCHAINS, theta.shape[0]),
                                            generator=gen, device=dev)
        cases = smoke.b2_cases(torch, st, st.read_bins, theta, thetas)
        for name, (cnt, nrm, rb, bv) in cases.items():
            want = kernels.lut_eval_plain(cnt, nrm, rb, bv)
            smoke.lut_equal(torch, kernels.lut_eval(cnt, nrm, rb, bv), want)
            del want
            big = rb.numel() * cnt.shape[0] // rb.shape[0] > 1e6
            out[name] = smoke.b2_measure(torch, kernels, cnt, nrm, rb, bv,
                                         50 if big else 200)
    return out


def _hist_at(torch, kernels, hs, x, th, nch: int, grid):
    """One B1 launch on ``grid`` = (blocks, slots) in place of the
    plan's (``kernels.launch_histogram_at``; a launch through the wrapper
    makes the plan first, so that the rule's grid can be read from it):
    ``(counts (nch, ndyn, total), norms (nch, ndyn))``."""
    if (nch, x.device.index) not in hs._b1:
        kernels._launch_histogram(hs, x, th, nch, "probe")
    return kernels.launch_histogram_at(hs, x, th, nch, tuple(grid))


def _probe() -> dict:
    """B1's grid, slot and split probe of this checkout (see the module
    docstring)."""
    _import_tree(str(HERE))
    import torch
    from sxmc_tpu_torch.ops import kernels

    smoke = _smoke()
    kernels.build()
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        cfg_path = smoke.write_example(workdir)
        for name, (hs, x, th, call) in b1_cases(
                torch, kernels, smoke, cfg_path, workdir).items():
            if name == "b1a":
                continue
            nch = 1 if th.dim() == 1 else th.shape[0]
            call()
            rule = hs._b1[(nch, x.device.index)][:2]  # (blocks, slots)
            want = kernels.segmented_histogram_plain(hs, x, th)
            grids = [rule] + [(nsm * b, rule[1]) for b in (1, 2, 3, 4)]
            grids += [(rule[0], s) for s in (0, 1, 8, 32) if s != rule[1]]
            res = {"rule": list(rule)}
            for grid in grids:
                def launch(grid=grid, hs=hs, x=x, th=th, nch=nch):
                    return _hist_at(torch, kernels, hs, x, th, nch, grid)
                try:
                    got = launch()
                except RuntimeError as e:  # slots past the budget
                    res[f"{grid[0]} blocks, {grid[1]} slots"] = str(e)[:80]
                    continue
                if hs.weighted:
                    same = all(smoke.equal_but_ties(torch, g, w.reshape(
                        g.shape), name) >= 0 for g, w in zip(got, want))
                else:
                    same = all(torch.equal(g, w.reshape(g.shape))
                               for g, w in zip(got, want))
                smoke.check(same, f"probe {name} {grid}: differs from plain")
                res[f"{grid[0]} blocks, {grid[1]} slots"] = smoke.device_ms(
                    torch, launch, 30, ("sx_hist_kernel",))
            # The split on the rule's grid, by composition.
            out_of_domain = kernels.HistSpec.build(
                hs.nfields, [1e30] * hs.nobs, [2e30] * hs.nobs, hs.nbins,
                hs.systematics, hs.seg_off, hs.weighted)
            empty = kernels.HistSpec.build(
                hs.nfields, hs.lower, hs.upper, hs.nbins, hs.systematics,
                [0] * len(hs.seg_off), hs.weighted)
            x0 = x[:, :0].contiguous()
            for tag, hs_, x_ in (("full", hs, x),
                                 ("loads only", out_of_domain, x),
                                 ("no rows", empty, x0)):
                res[f"split {tag}"] = smoke.device_ms(
                    torch, lambda: _hist_at(torch, kernels, hs_, x_, th, nch,
                                            rule), 30, ("sx_hist_kernel",))
            for b in (1, 2):
                res[f"no rows at {nsm * b} blocks"] = smoke.device_ms(
                    torch, lambda: _hist_at(torch, kernels, empty, x0, th,
                                            nch, (nsm * b, rule[1])),
                    30, ("sx_hist_kernel",))
            # Yardstick: torch's sum over the same bytes (the fields the
            # binning reads, and the weights).
            rows = x[:min(x.shape[0], hs.nload + 1 + int(hs.weighted))]
            res["torch sum of the rows read"] = smoke.device_ms(
                torch, lambda: rows.sum(), 30, ("reduce",))
            out[name] = res
            print(f"probe {name}: {json.dumps(res)}", flush=True)
    return out


def _library(tree: str):
    """(the newest built library, its build log) under ``tree``."""
    libs = sorted(pathlib.Path(tree).glob(
        "build/sxmc_kernels/*/libsxmc_kernels.so"),
        key=lambda p: p.stat().st_mtime)
    if not libs:
        raise SystemExit(f"no built library under {tree}")
    log = libs[-1].parent / "build.log"
    return libs[-1], log.read_text() if log.exists() else ""


def sass_counts(lib: pathlib.Path, nvcc_dir: str) -> dict:
    """SASS instructions of each B1 kernel in ``lib``: the function's,
    and the span from its first global load to its last shared atomic."""
    text = subprocess.run([os.path.join(nvcc_dir, "cuobjdump"), "-sass",
                           str(lib)], capture_output=True, text=True).stdout
    out = {}
    name = None
    ops = []
    instr = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")

    def done():
        if name and "sx_hist_kernel" in name:
            first = next((i for i, op in enumerate(ops)
                          if re.search(r"\bLDG\b", op)), 0)
            last = max((i for i, op in enumerate(ops)
                        if re.search(r"\bATOMS\b", op)),
                       default=len(ops) - 1)
            out[name] = {"instructions": len(ops),
                         "row_loop_span": last - first + 1}

    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            done()
            name, ops = m.group(1), []
            continue
        m = instr.match(line)
        if m and name:
            ops.append(m.group(1))
    done()
    return out


def ptxas_table(log: str) -> dict:
    """ptxas's registers, spill stores and spill loads of each kernel."""
    out = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out.setdefault(fn, {})["spill"] = [int(m.group(1)),
                                               int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.setdefault(fn, {})["registers"] = int(m.group(1))
    return out


def library_report(other: str) -> dict:
    """SASS counts of both checkouts' B1 kernels, and the kernels whose
    spills THIS has and OTHER has not."""
    sys.path.insert(0, str(HERE))
    from sxmc_tpu_torch.ops import kernels

    nvcc_dir = os.path.dirname(kernels._nvcc())
    rep = {}
    tables = {}
    for tag, tree in (("other", other), ("this", str(HERE))):
        lib, log = _library(tree)
        rep[f"{tag} sass"] = sass_counts(lib, nvcc_dir)
        tables[tag] = ptxas_table(log)
        rep[f"{tag} registers"] = {k: v.get("registers")
                                   for k, v in tables[tag].items()}
        rep[f"{tag} spills"] = {k: v.get("spill")
                                for k, v in tables[tag].items()}
    new_spills = {k: v["spill"] for k, v in tables["this"].items()
                  if any(v.get("spill", [0, 0]))
                  and tables["other"].get(k, {}).get("spill") != v["spill"]}
    rep["spills this has and other has not"] = new_spills
    return rep


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", help="the other checkout's root")
    ap.add_argument("--json", help="also write the runs to this file")
    ap.add_argument("--skip-turns", action="store_true",
                    help="only the probe and the library reports")
    ap.add_argument("--binned", type=int, default=0, metavar="ROUNDS",
                    help="only the binned 8-chain path's study, in ROUNDS "
                         "rounds of turns")
    ap.add_argument("--b2", type=int, default=0, metavar="ROUNDS",
                    help="only B2's study, in ROUNDS rounds of turns")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    ap.add_argument("--measure-b2", help=argparse.SUPPRESS)
    ap.add_argument("--measure-binned", help=argparse.SUPPRESS)
    ap.add_argument("--probe", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        print("TURN " + json.dumps(_measure(args.measure)), flush=True)
        return 0
    if args.measure_binned:
        print("TURN " + json.dumps(_measure_binned(args.measure_binned)),
              flush=True)
        return 0
    if args.measure_b2:
        print("TURN " + json.dumps(_measure_b2(args.measure_b2)),
              flush=True)
        return 0
    if args.probe:
        print("TURN " + json.dumps(_probe()), flush=True)
        return 0
    if not args.other:
        ap.error("give the other checkout's root")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_turns: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    other = str(pathlib.Path(args.other).resolve())
    turns = (other, str(HERE), str(HERE), other)
    if args.binned or args.b2:
        flag, rounds = (("--measure-binned", args.binned) if args.binned
                        else ("--measure-b2", args.b2))
        jobs = [[flag, tree] for _ in range(rounds) for tree in turns]
    else:
        jobs = [["--probe"]]
        if not args.skip_turns:
            jobs = [["--measure", tree] for tree in turns] + jobs
    runs = []
    for job in jobs:
        proc = subprocess.run(
            [sys.executable, str(HERE / "bench_turns.py"), *job],
            capture_output=True, text=True, cwd=str(HERE))
        line = [x for x in proc.stdout.splitlines() if x.startswith("TURN ")]
        if proc.returncode != 0 or not line:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            raise SystemExit(f"bench_turns: the run {job} failed")
        run = dict(json.loads(line[0][5:]), card=smi, run=job[0])
        runs.append(run)
        print(json.dumps(run), flush=True)
    if args.skip_turns:
        # Build the other checkout's library for its report.
        subprocess.run([sys.executable, "-c",
                        "from sxmc_tpu_torch.ops import kernels; "
                        "kernels.build()"], cwd=other, check=True)
    if not args.binned and not args.b2:
        rep = dict(library_report(other), card=smi, run="library")
        runs.append(rep)
        print(json.dumps(rep), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(runs, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
