"""Smoke test of the PyTorch/CUDA port (sxmc_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one Hopper card.  It

  1. prints the card (nvidia-smi name and power limit) and toolchain;
  2. builds the hand-written kernels from sxmc_tpu_torch/csrc with nvcc;
  3. holds each kernel against its plain PyTorch version on the card,
     on the same inputs, and times both (CUDA events):
       B1 segmented_histogram: the slice's 2-signal layout (2 x 500k MC
          rows, 10 bins, scale + resolution systematics) and the 10M-
          sample / 1000-bin / 1-shift shape; counts must be equal;
       B3 fused_nll: the NLL at the nominal and a perturbed parameter
          point, |dNLL| <= NLL_TOL;
       B4 fused_segment: a 500-step segment fed identical noise; accept
          decisions and parameters identical, NLL history within NLL_TOL;
  4. runs the default fit through the port's CLI (--device cuda) on the
     reference example (examples/reference_example.json: 2 signals x
     500k rows, 10 energy bins, a radius cut, floating scale and
     resolution, 100k steps), with every launch counter reset just
     before and read just after, and checks that each kernel ran, that
     no experiment failed, and that the fit is sane;
  5. prints the kernels' JSON line, the card line, and as its last line
     {"ok": true, "device": {...}}.

It exits non-zero, printing no result, when CUDA is unavailable, when
the package is missing (run from the checkout's root), or when any
check fails.  It imports nothing of JAX.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# |dNLL| allowed between a fused kernel and its plain version: the event
# sum is float64 in both, summed in another order, and float32 logf in
# both; 1e-3 is far below the 0.5 dNLL the intervals resolve.
NLL_TOL = 1e-3
SEGMENT_STEPS = 500


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def run(cmd) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def in_turns(torch, plain, kernel, reps_plain: int, reps_kernel: int):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1 = cuda_ms(torch, plain, reps_plain)
    k1 = cuda_ms(torch, kernel, reps_kernel)
    k2 = cuda_ms(torch, kernel, reps_kernel)
    p2 = cuda_ms(torch, plain, reps_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def write_example(workdir: str, nevents: int = 500_000) -> str:
    """The examples/make_example.py tables and the reference example's
    configuration (npz output, no plots), written with numpy."""
    from sxmc_tpu_torch.io import loaders

    rng = np.random.default_rng(1234)
    fields = ["energy", "mc_energy", "radius"]
    mc1 = rng.normal(10.0, 0.2, nevents).astype(np.float32)
    e1 = (mc1 + rng.normal(0, 0.8, nevents)).astype(np.float32)
    sig1 = np.stack([e1, mc1, rng.uniform(0, 10, nevents).astype(
        np.float32)], axis=1)
    mc2 = (5.0 + rng.exponential(3.0, nevents)).astype(np.float32)
    e2 = (mc2 + rng.normal(0, 0.8, nevents)).astype(np.float32)
    sig2 = np.stack([e2, mc2, rng.uniform(0, 10, nevents).astype(
        np.float32)], axis=1)
    for name, table in (("signal1", sig1), ("signal2", sig2)):
        loaders.write_float_table(os.path.join(workdir, f"{name}.npz"),
                                  table, fields)
    systs = ["energy_scale", "energy_resolution"]
    config = {
        "fit": {"nexperiments": 1, "nsteps": 100000,
                "burnin_fraction": 0.2, "signal_name": "signal1",
                "output_file": "example", "signals": ["signal1", "signal2"],
                "observables": ["energy"], "cuts": ["radius"], "seed": 42,
                "output_format": "npz", "plots": False},
        "pdfs": {
            "observables": {
                "energy": {"title": "Energy (MeV)", "units": "MeV",
                           "field": "energy", "bins": 10,
                           "min": 5.0, "max": 15.0},
                "radius": {"title": "Radius (m)", "units": "m",
                           "field": "radius", "bins": 10,
                           "min": 0.0, "max": 10.0}},
            "systematics": {
                "energy_scale": {"title": "Energy scale", "type": "scale",
                                 "observable_field": "energy",
                                 "mean": [0.0], "sigma": [1e-2]},
                "energy_resolution": {
                    "title": "Energy resolution",
                    "type": "resolution_scale",
                    "observable_field": "energy",
                    "true_field": "mc_energy",
                    "mean": [0.0], "sigma": [1e-3]}}},
        "signals": {
            "signal1": {"title": "Signal 1", "filename": "signal1.npz",
                        "dataset": 0, "systematics": systs,
                        "scale": 500.0, "sigma": 0.05},
            "signal2": {"title": "Signal 2", "filename": "signal2.npz",
                        "dataset": 0, "systematics": systs,
                        "scale": 1000.0}},
    }
    path = os.path.join(workdir, "example.json")
    with open(path, "w") as f:
        json.dump(config, f, indent=1)
    return path


def check_kernels(torch, kernels, config_path: str, workdir: str):
    """Phase 3: each kernel against its plain version on the card."""
    from sxmc_tpu_torch.fitconfig import FitConfig
    from sxmc_tpu_torch.generator import make_fake_dataset
    from sxmc_tpu_torch.mcmc.metropolis import MCMC, initial_state
    from sxmc_tpu_torch.ops.transforms import SHIFT, SystematicDesc
    from sxmc_tpu_torch.signal import nominal_params

    dev = torch.device("cuda")
    out = {}

    # B1 at the slice's layout: the example's two dynamic segments.
    fc = FitConfig.from_json_file(config_path, data_root=workdir)
    mcmc = MCMC(fc.sources, fc.signals, fc.systematics, fc.observables,
                device=dev)
    st = mcmc.stack
    hs = st.hist_spec
    theta = torch.as_tensor(nominal_params(fc.systematics), device=dev)
    got, got_norms = kernels.segmented_histogram(hs, st.samples, theta)
    want, want_norms = kernels.segmented_histogram_plain(hs, st.samples,
                                                         theta)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"B1 slice counts differ (max {err})")
    check(torch.equal(got_norms, want_norms), "B1 slice norms differ")
    ms, plain_ms = in_turns(
        torch, lambda: kernels.segmented_histogram_plain(hs, st.samples,
                                                         theta),
        lambda: kernels.segmented_histogram(hs, st.samples, theta), 5, 50)
    print(f"B1 segmented_histogram, {hs.ndyn} x {hs.n // hs.ndyn} samples, "
          f"{hs.total} bins: counts and norms equal; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")
    b1 = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    # B1 at 10M samples, 1000 bins, one shift systematic.
    n = 10_000_000
    gen = torch.Generator(dev).manual_seed(7)
    x = torch.rand((1, n), generator=gen, device=dev) * 12.0 + 4.0
    hs10 = kernels.HistSpec.build(
        1, [5.0], [15.0], [1000],
        [(SystematicDesc(type=SHIFT, obs=0, par_indices=(0,)), (True,))],
        [0, n])
    th10 = torch.as_tensor([0.0137], device=dev)
    got = kernels.segmented_histogram(hs10, x, th10)
    want = kernels.segmented_histogram_plain(hs10, x, th10)
    torch.cuda.synchronize()
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "B1 10M-sample counts or norms differ")
    ms10, plain10 = in_turns(
        torch, lambda: kernels.segmented_histogram_plain(hs10, x, th10),
        lambda: kernels.segmented_histogram(hs10, x, th10), 3, 20)
    print(f"B1 segmented_histogram, 1 x {n} samples, 1000 bins, shift: "
          f"counts and norms equal; kernel {ms10:.4f} ms ({n / ms10 * 1e3:.4g} "
          f"samples/s), plain {plain10:.4f} ms")
    b1.update(headline_ms=ms10, headline_plain_ms=plain10,
              headline_samples_per_s=n / ms10 * 1e3)
    out["segmented_histogram"] = b1
    del x

    # B3 at the nominal and at a perturbed point, on a fake dataset.
    data = make_fake_dataset(torch.Generator().manual_seed(3), fc.signals,
                             fc.systematics, fc.observables, stack=st)
    st.set_data(data)
    rb = st.read_bins
    ns = st.nll_spec(mcmc.static)
    p0 = torch.as_tensor(mcmc.parameter_means, device=dev)
    p1 = p0 + torch.as_tensor([0.03, -0.05, 0.004, 0.0007], device=dev)
    errs = []
    for p in (p0, p1):
        hi, lo = kernels.fused_nll(hs, ns, st.samples, st.hist_init, rb, p)
        phi, plo = kernels.fused_nll_plain(hs, ns, st.samples,
                                           st.hist_init, rb, p)
        errs.append(abs(float(hi.double() + lo.double())
                        - float(phi.double() + plo.double())))
    err = max(errs)
    check(err <= NLL_TOL, f"B3 NLL differs by {err} > {NLL_TOL}")
    ms, plain_ms = in_turns(
        torch, lambda: kernels.fused_nll_plain(hs, ns, st.samples,
                                               st.hist_init, rb, p1),
        lambda: kernels.fused_nll(hs, ns, st.samples, st.hist_init, rb, p1),
        5, 50)
    print(f"B3 fused_nll, {rb.shape[1]} events: |dNLL| {err:.3g} <= "
          f"{NLL_TOL}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    out["fused_nll"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    # B4: a 500-step segment fed identical noise.
    params, nll0, width = initial_state(mcmc, rb)
    nll0 = torch.stack(nll0)
    gen = torch.Generator(dev).manual_seed(11)
    noise = torch.randn((SEGMENT_STEPS, mcmc.nparameters), generator=gen,
                        device=dev)
    log_u = torch.log(torch.rand(SEGMENT_STEPS, generator=gen, device=dev))
    args = (hs, ns, st.samples, st.hist_init, rb, params, nll0, width,
            noise, log_u)
    s, nl, a = kernels.fused_segment(*args)
    ps, pnl, pa = kernels.fused_segment_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(a, pa), "B4 accept decisions differ")
    check(torch.equal(s, ps), "B4 parameter trajectories differ")
    err = float((nl.double().sum(1) - pnl.double().sum(1)).abs().max())
    check(err <= NLL_TOL, f"B4 NLL history differs by {err}")
    ms, plain_ms = in_turns(
        torch, lambda: kernels.fused_segment_plain(*args),
        lambda: kernels.fused_segment(*args), 1, 10)
    print(f"B4 fused_segment, {SEGMENT_STEPS} steps: trajectory identical "
          f"(accept rate {float(a.mean()):.3f}), |dNLL| {err:.3g}; kernel "
          f"{ms:.4f} ms ({ms / SEGMENT_STEPS * 1e3:.2f} us/step), plain "
          f"{plain_ms:.4f} ms")
    out["fused_segment"] = {"max_abs_err": err, "ms": ms,
                            "plain_ms": plain_ms}
    return out


def main_path(torch, kernels, config_path: str, workdir: str):
    """Phase 4: the default fit through the CLI, counters around it."""
    from sxmc_tpu_torch.cli import main as cli_main

    out = os.path.join(workdir, "out")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli_main([config_path, out, "--data-root", workdir,
                   "--device", "cuda", "--max-retries", "0"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    check(rc == 0, f"cli returned {rc}")
    with open(os.path.join(out, "example_metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    failed = [r for r in recs if r["event"] == "experiment_failed"]
    check(not failed, f"an experiment failed: {failed}")
    limits = [r["upper"] for r in recs if r["event"] == "experiment_limit"]
    check(len(limits) == 1 and all(math.isfinite(x) for x in limits),
          f"limits {limits}")
    fit = next(r for r in recs if r["event"] == "experiment_fit")
    result = next(r for r in recs if r["event"] == "experiment_result")
    check(0.02 < fit["accept_rate"] < 0.95,
          f"acceptance rate {fit['accept_rate']}")
    best = result["best_fit"]
    check(all(math.isfinite(v) for v in best.values()), f"best fit {best}")
    # The fake data is drawn at the nominal rates: the fitted signal1
    # rate sits near 1 (about 1000 expected events, ~5% statistical).
    check(0.7 < best["signal1"] < 1.3, f"best-fit signal1 {best['signal1']}")
    from sxmc_tpu_torch.stats.likelihood import LikelihoodSpace

    ls = LikelihoodSpace.load(os.path.join(out, "example_0.npz"))
    check(ls.samples.shape == (60000, 4) and np.isfinite(ls.samples).all()
          and np.isfinite(ls.nll_values).all(), "likelihood space")
    for name in ("segmented_histogram", "fused_nll", "fused_segment"):
        check(counts[name] > 0, f"{name} was not launched on the main path")
    print(f"main path: limit {limits[0]:.6g}, best fit {best}, accept rate "
          f"{fit['accept_rate']:.4f}, fit {fit['wall_seconds']:.3f} s = "
          f"{fit['steps_per_sec']:.6g} steps/s, whole CLI run {wall:.2f} s; "
          f"launches {counts}")
    return counts, fit


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    try:
        from sxmc_tpu_torch.ops import kernels
    except ImportError as e:
        fail(f"sxmc_tpu_torch is not importable ({e}); run from the "
             "checkout's root")

    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    print(f"card: {smi}")
    nvcc = kernels._nvcc()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, nvcc: "
          f"{run([nvcc, '--version']).splitlines()[-1]}")
    try:
        import triton
        print(f"triton {triton.__version__} (not used)")
    except ImportError:
        print("triton: not installed")

    t0 = time.perf_counter()
    info = kernels.build()
    kernels._library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{info['seconds']:.2f} s) -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print("  " + line.strip())

    with tempfile.TemporaryDirectory() as workdir:
        config_path = write_example(workdir)
        measured = check_kernels(torch, kernels, config_path, workdir)
        counts, fit = main_path(torch, kernels, config_path, workdir)

    src = "sxmc_tpu_torch/csrc/sxmc_kernels.cu"
    replaces = {
        "segmented_histogram": "sxmc_tpu/ops/pallas_hist.py:416",
        "fused_nll": "sxmc_tpu/ops/pallas_step.py:451",
        "fused_segment": "sxmc_tpu/ops/pallas_step.py:808",
    }
    rows = [dict(name=name, route="cuda", source=src,
                 replaces=replaces[name], launches=counts[name],
                 **measured[name])
            for name in replaces]
    print(f"main path: {fit['steps_per_sec']!r} steps/s on {smi}")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
