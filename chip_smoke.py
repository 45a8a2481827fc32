"""Smoke test of the PyTorch/CUDA port (sxmc_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one Hopper card.  It

  1. prints the card (nvidia-smi name and power limit) and toolchain;
  2. builds the hand-written kernels from sxmc_tpu_torch/csrc with nvcc
     and prints what ptxas says of each (registers, spills);
  3. holds each kernel and form against its plain PyTorch version on
     the card, on the same inputs, and times both (CUDA events, in
     turns: plain, kernel, kernel, plain):
       B1 segmented_histogram: the slice's 2-signal layout (2 x 500k MC
          rows, 10 bins, scale + resolution systematics) and the 10M-
          sample / 1000-bin / 1-shift shape; counts must be equal;
       B1 segmented_histogram_batched: 8 chains on the slice's layout;
          then B1 at segment offsets and a total that are not multiples
          of 4 with an empty segment, at 1, 8 and 32 chains, unweighted
          and weighted, in shared-memory slots and (1,000 bins x 8 and 32
          chains) with every count a global atomic; 18 calls back to back
          without a synchronisation, layouts alternating (a stale
          persistent accumulator would show); and one B1 call under
          torch.profiler, which must show exactly one device operation;
          each B1 form's times are printed, and on a line of their own
          those before its redesign (B1_BEFORE, copied from PERF.md);
       B2 lut_eval: the reference example's LUT (2 signals x its
          events, 10 bins) and 2 signals x 1M events x 1000 bins; values
          equal; EvalHist.eval (B1 + B2) on signal1's 500k rows;
       B3 fused_nll / fused_nll_batched: the NLL at the nominal and a
          perturbed point, and at 8 chains, |dNLL| <= NLL_TOL;
       B4 fused_segment / fused_segment_batched: a 500-step segment,
          and one of 8 lock-step chains, fed identical noise; accept
          decisions and parameters identical, NLL history within
          NLL_TOL; B4-batched also at 32 chains (the most one launch
          takes) and at 8 chains x 1,000 energy bins (histograms too
          large for the shared-memory replicas); B1, B3, B4-batched and
          B5-batched on the wide example (two observables, a moved truth
          field), and on the far one (a systematic moves sample field 4,
          nload = 5: the forms that bin every field in registers) B1, B3
          one chain and 8, B4 one chain (diagonal and tril), B5 one chain,
          B4- and B5-batched, and weighted B1, B3 and B4-batched;
       B4 fused_segment_tril / fused_segment_tril_batched (full-
          covariance proposals cur + L @ z): the same, with correlated
          lower-triangular scales, and the full_cov retune between
          phases timed (the process's first Cholesky, then a warm one);
       B5 blocked_segment / blocked_segment_batched (blocked
          Metropolis-within-Gibbs): 500 cycles of one systematic move
          and M = 4 rate moves, one chain and 8, the same checks; and
          B5 at M = 1 beside it, which prices a rate move against a
          rebuild step;
       B1 through EvalHist.histogram on signal1's 500k rows;
       B4 fused_segment_tempered: a 500-step segment of an 8-replica
          ladder (beta from 1 to 1/32), the same checks;
       the weighted forms, on the example with a log-normal (sigma 0.3)
          weight per MC row: B1 (and at 10M samples x 1000 bins), B1-
          batched, B1a (EvalHist.histogram), B3 one chain and 8, B4 one
          chain and 8, diagonal, tril and tempered: bins equal but where
          a float64 sum sits on a float32 rounding tie (such bins are
          counted and printed, at most an ulp apart), decisions and
          parameters identical (else the first diverging step is
          printed), |dNLL| <= NLL_TOL;
       the experiment-grouped forms of the sharded ensemble (B4
          diagonal and tril, unweighted and weighted; B5 at M = 4), 4
          fake experiments x 2 chains of the example, 500 steps: each
          against its plain version (the same checks), and against the
          batched form run experiment by experiment on the same noise
          (identical decisions); then, at bench.py's
          bench_sharded_ensemble shape (2 signals x 1M MC rows, 100
          bins, a shift systematic, 3,000 - 7 e events in experiment
          e), B4-grouped at 4 x 2 chains against B4-batched at 8 chains
          on one dataset, in turns, with card time from torch.profiler;
  4. runs the port's CLI (--device cuda) on the reference example
     (examples/reference_example.json: 2 signals x 500k rows, 10 energy
     bins, a radius cut, scale and resolution systematics) on every path:
     the default fit; "nchains": 8; both systematics fixed; --binned with
     "nchains": 8; "proposal": "full_cov", alone and with 8 chains;
     "rate_substeps": 4, alone and with 8 chains; "rate_substeps": 4
     with --binned; "proposal": "full_cov" with fixed systematics; then
     --sampler tempered (the JAX defaults: 8 replicas up to T = 32, a
     swap every 10 steps), alone and with fixed systematics; and,
     through run_ensemble with both signals weighted (the config has no
     weights key), a weighted fit alone, with 8 chains, with full_cov,
     with full_cov and 8 chains, and tempered; then the sharded ensemble
     (4 experiments x 2 chains as one batch) through --sharded: diagonal,
     "proposal": "full_cov", "rate_substeps": 4 and --binned (the
     stepper, experiment by experiment), and through
     run_sharded_ensemble with both signals weighted: diagonal and
     full_cov: 23 paths; then the frequentist tier, 200 toys each:
     --sampler mle --gof 100, --sampler mle --binned, the default fit
     with --hypotest 200 --hypotest-band --hypotest-asymptotic,
     --sampler mle --bias-study 200, and FeldmanCousins.run through the
     library (8 grid points x 200 toys): 28 paths.  Every launch counter
     is reset just before each run and read just after; each run must
     launch exactly its path's kernels, end with a finite limit (four on
     the sharded paths; the tier's JSON outputs finite) and no failed
     experiment, and fit sanely.  The runs on the
     stepper loop (fixed, binned) take fewer steps, printed as a cut;
     blocked runs also print parameter updates/s, sharded runs their
     fake-data set-up apart from the fit; a profiled tempered fit splits
     its wall into kernel and host time;
     The MLE of the example with the kernels is held against
     device="cpu" on the same data (best-fit NLL within NLL_TOL; free
     rates, profile limit and Asimov limit within 1e-3 relative), and
     the toys' dNLL with B2 against lut_eval_plain on the card;
  5. prints the kernels' JSON line (every kernel and form: launches on
     the paths, error, times, bound, library time), the card line, and
     as its last line {"ok": true, "device": {...}}.

It exits non-zero, printing no result, when CUDA is unavailable, when
the package is missing (run from the checkout's root), or when any
check fails.  It imports nothing of JAX.
"""

import ctypes
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
NCHAINS = 8
FULL_STEPS = 100_000   # the example's nsteps
LOOP_STEPS = 8_000     # the stepper-loop paths' cut (host-bound)
SHORT_STEPS = 1_000    # the cut of the later options' stepper-loop paths
RATE_SUBSTEPS = 4      # M of the blocked runs (README, bench.py)
SPLIT_STEPS = 20_000   # the profiled tempered fit (2,000 swap intervals)
NEXP, CPE = 4, 2       # the sharded paths: experiments x chains each
NTEMPS, TMAX, SWAP_EVERY = 8, 32.0, 10  # the tempered sampler's defaults
WEIGHT_SIGMA = 0.3     # log-normal per-row MC weights of the weighted runs

# B1's times before its redesign (ms with calls back to back, CUDA
# events; ms on the card, torch.profiler), copied from PERF.md's kernel
# table (this script's run on an NVIDIA H100 80GB HBM3 at 700 W before
# the redesign).  They are printed beside this run's times, on lines of
# their own, and are not part of the kernels line: every number there is
# this run's.
B1_BEFORE = {
    "one theta, 2 x 500k, 10 bins": (0.0565, 0.0119),
    "one theta, 10M, 1,000 bins": (0.0708, 0.0576),
    "8 chains, 2 x 500k": (0.0529, 0.0481),
    "weighted, 2 x 500k": (0.0593, 0.0212),
    "weighted, 10M, 1,000 bins": (0.1121, 0.1043),
    "weighted, 8 chains": (0.1231, 0.1092),
    "B1a, 500k, 10 bins": (0.1009, 0.0077),
    "B1a weighted, 500k, 10 bins": (0.1598, 0.0133),
}

# The H100 SXM's published peaks: HBM bytes/s
# and float32 operations/s outside the tensor cores, at 700 W.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SRC = "sxmc_tpu_torch/csrc/sxmc_kernels.cu"  # B2, and the C interface
SRC_B1 = "sxmc_tpu_torch/csrc/sxmc_hist.cu"
SRC_FUSED = "sxmc_tpu_torch/csrc/sxmc_fused.cuh"  # B3-B5
REPLACES = {
    "segmented_histogram": "sxmc_tpu/ops/pallas_hist.py:416",
    "segmented_histogram_batched": "sxmc_tpu/ops/pallas_hist.py:416",
    "lut_eval": "sxmc_tpu/ops/pallas_hist.py:656",
    "fused_nll": "sxmc_tpu/ops/pallas_step.py:451",
    "fused_nll_batched": "sxmc_tpu/ops/pallas_step.py:451",
    "fused_segment": "sxmc_tpu/ops/pallas_step.py:808",
    "fused_segment_batched": "sxmc_tpu/ops/pallas_step.py:808",
    "fused_segment_tril": "sxmc_tpu/ops/pallas_step.py:808",
    "fused_segment_tril_batched": "sxmc_tpu/ops/pallas_step.py:808",
    "blocked_segment": "sxmc_tpu/ops/pallas_step.py:1239",
    "blocked_segment_batched": "sxmc_tpu/ops/pallas_step.py:1239",
    "fused_segment_tempered": "sxmc_tpu/ops/pallas_step.py:808",
    "fused_segment_grouped": "sxmc_tpu/ops/pallas_step.py:808",
    "fused_segment_tril_grouped": "sxmc_tpu/ops/pallas_step.py:808",
    "blocked_segment_grouped": "sxmc_tpu/ops/pallas_step.py:1239",
}
# Each weighted form replaces its unweighted form's TPU kernel (the
# has_weights / has_wrow branches of the same pallas_call).
REPLACES.update({f"{k}_weighted": v for k, v in list(REPLACES.items())
                 if k != "lut_eval" and not k.startswith("blocked")})


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


def device_ms(torch, fn, reps: int, names) -> float:
    """Milliseconds per call that the kernels whose names contain one of
    ``names`` spent on the card (torch.profiler), without the host's
    launch gaps that the CUDA-event times include; None when the
    profiler records no such kernel.  Each such kernel runs once per
    call of ``fn``; the time is the mean over the launches the profiler
    recorded (it may drop some of a run of long launches: that is
    printed, and the mean stays that of whole launches)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_ms = 0.0
    for ev in prof.key_averages():
        if any(n in ev.key for n in names) and ev.count:
            us = (getattr(ev, "device_time_total", None)
                  or getattr(ev, "cuda_time_total", 0.0))
            total_ms += us / 1e3 / ev.count
            if ev.count != reps:
                print(f"torch.profiler recorded {ev.count} of {reps} "
                      f"launches of {ev.key[:40]}")
    return total_ms or None


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the float32 operations over the float32 peak."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations"}


def binning_ops(hs, nchains: int = 1) -> float:
    """Float operations to bin every sample of ``hs`` once per chain, as
    the kernel's arithmetic has them: 2 per power-series term and 2 for
    the transform of each systematic acting on the sample's segment, 5
    per observable (2 compares, subtract, multiply, floor), 1 increment."""
    ops = 0.0
    for d in range(hs.ndyn):
        n = hs.seg_off[d + 1] - hs.seg_off[d]
        per = 5 * hs.nobs + 1 + sum(2 * desc.npars + 2
                                    for desc, mask in hs.systematics
                                    if mask[d])
        ops += n * per
    return ops * nchains


def weight_ops(hs, nchains: int = 1) -> float:
    """A weighted rebuild's extra operation per binning: the weight is
    added to the in-domain norm as well as to the bin."""
    return float(hs.n * nchains) if hs.weighted else 0.0


def sample_bytes_read(hs) -> float:
    """Bytes of the MC samples a rebuild must read: the observables and
    the fields after them that a systematic transforms, the second field
    of each other resolution systematic, and the weight row of weighted samples (other fields,
    such as the dataset tag, are not read)."""
    from sxmc_tpu_torch.ops.transforms import RESOLUTION_SCALE

    fields = set(range(hs.nload)) | {
        desc.extra_field for desc, mask in hs.systematics
        if desc.type == RESOLUTION_SCALE and any(mask)}
    return 4.0 * (len(fields) + int(hs.weighted)) * hs.n


def event_ops(nsig: int, nev: int) -> float:
    """Per event: a multiply, a divide and an add per signal, one log."""
    return nev * (3 * nsig + 1)


def b1_form(name: str, ms: float, dms, bnd: dict) -> dict:
    """One B1 form's entry of the kernels line: its times in this run and
    its bound.  The times before the redesign (B1_BEFORE, copied from
    PERF.md) are printed on a line of their own, not returned."""
    before, before_dev = B1_BEFORE[name]
    print(f"B1 form {name}: {ms:.4f} ms with calls back to back, on the "
          f"card {dms} ms, bound {bnd['bound_ms']:.4f} ms "
          f"({bnd['bound_by']})")
    print(f"B1 form {name}, before the redesign (copied from PERF.md, not "
          f"measured here): {before} ms back to back, {before_dev} ms on "
          "the card")
    return {name: {"ms": ms, "device_ms": dms, **bnd}}


def lut_equal(torch, got, want) -> float:
    """Max |got - want| where both are finite; fails unless the NaNs sit
    in the same places and every value is equal."""
    check(torch.equal(torch.isnan(got), torch.isnan(want)),
          "LUT NaN sentinels differ")
    a, b = torch.nan_to_num(got), torch.nan_to_num(want)
    err = float((a - b).abs().max()) if a.numel() else 0.0
    check(torch.equal(a, b), f"LUT values differ (max {err})")
    return err


def equal_but_ties(torch, got, want, what: str) -> int:
    """Weighted bins and norms: float64 sums rounded once to float32, so
    the kernel equals its plain version except where the float64 sum
    sits on a float32 rounding tie (the two float64 sums, added in
    another order, fall on either side): such values may be one ulp
    apart.  Fails on anything else; returns how many differ."""
    diff = got != want
    ulp = torch.abs(torch.nextafter(want, torch.full_like(want, math.inf))
                    - want)
    check(bool((torch.abs(got - want)[diff] <= ulp[diff]).all()),
          f"{what}: values differ by more than an ulp")
    return int(diff.sum())


def same_walk(torch, name, got, want):
    """Identical accept decisions and parameters, |dNLL| <= NLL_TOL;
    prints and fails at the first diverging step."""
    s, nl, a = got
    ps, pnl, pa = want
    n = s.shape[0]
    same = ((s == ps).reshape(n, -1).all(1)
            & (a == pa).reshape(n, -1).all(1))
    if not bool(same.all()):
        first = int((~same).nonzero()[0])
        fail(f"{name}: decisions or parameters diverge at step {first}")
    err = float((nl.double().sum(-1) - pnl.double().sum(-1)).abs().max())
    check(err <= NLL_TOL, f"{name}: NLL history differs by {err}")
    return err


def weighted_fit(config_path: str, workdir: str):
    """The example's fit with both signals weighted: log-normal
    (sigma WEIGHT_SIGMA) float32 weights per MC row, drawn from a seed."""
    from sxmc_tpu_torch.fitconfig import FitConfig

    fc = FitConfig.from_json_file(config_path, data_root=workdir)
    rng = np.random.default_rng(23)
    for sig in fc.signals:
        sig.histogram.weights = rng.lognormal(
            0.0, WEIGHT_SIGMA, sig.n_mc).astype(np.float32)
    return fc


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
        "fit": {"nexperiments": 1, "nsteps": FULL_STEPS,
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


def b1_edge_layout(torch, kernels, nbins: int, weighted: bool, seed: int):
    """A B1 layout whose offsets and total are not multiples of 4:
    segments of 250,001, 2, 500,003, 0 and 250,002 rows (n =
    1,000,008), three fields (energy, true, a spare one), a scale (segments 0,
    2, 4), a resolution reading field 1 (0, 1, 4) and a two-term shift
    (1, 2, 4: a per-row power series); theta is (scale, res, shift a0,
    shift a1).  Samples drawn on the card from ``seed``."""
    from sxmc_tpu_torch.ops.transforms import (RESOLUTION_SCALE, SCALE,
                                               SHIFT, SystematicDesc)

    dev = torch.device("cuda")
    sizes = [250_001, 2, 500_003, 0, 250_002]
    seg_off = [0] + list(np.cumsum(sizes))
    n = seg_off[-1]
    systs = [
        (SystematicDesc(type=SCALE, obs=0, par_indices=(0,)),
         (True, False, True, False, True)),
        (SystematicDesc(type=RESOLUTION_SCALE, obs=0, extra_field=1,
                        par_indices=(1,)), (True, True, False, False, True)),
        (SystematicDesc(type=SHIFT, obs=0, par_indices=(2, 3)),
         (False, True, True, False, True))]
    hs = kernels.HistSpec.build(3, [5.0], [15.0], [nbins], systs, seg_off,
                                weighted=weighted)
    gen = torch.Generator(dev).manual_seed(seed)
    true = torch.rand((1, n), generator=gen, device=dev) * 12.0 + 4.0
    rows = [true + 0.6 * torch.randn((1, n), generator=gen, device=dev),
            true, torch.rand((1, n), generator=gen, device=dev)]
    if weighted:
        rows.append(torch.exp(WEIGHT_SIGMA * torch.randn(
            (1, n), generator=gen, device=dev)))
    return hs, torch.cat(rows).contiguous()


def b1_edge_thetas(torch, nch: int, seed: int):
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(seed)
    scale = torch.as_tensor([0.02, 0.01, 0.3, 0.01], device=dev)
    th = torch.randn((nch, 4), generator=gen, device=dev) * scale
    return th[0] if nch == 1 else th


def b1_equal(torch, got, want, weighted: bool, what: str) -> int:
    """Counts and norms equal (weighted: but on rounding ties, counted)."""
    if weighted:
        return (equal_but_ties(torch, got[0], want[0], what + " bins")
                + equal_but_ties(torch, got[1], want[1], what + " norms"))
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"{what}: counts or norms differ")
    return 0


def check_b1_edges(torch, kernels, st, theta):
    """B1 at offsets and a total that are not multiples of 4, an empty
    segment, 1, 8 and 32 chains, unweighted and weighted, the counts in
    shared-memory slots or (8 and 32 chains x 1,000 bins) every count a
    global atomic; then calls back to back on one stream without a
    synchronisation, layouts, chain counts and weightedness alternating,
    each against its plain version (an accumulator left dirty would
    show); then one call of B1-batched on the example (``st``, 8 chains
    around ``theta``) under torch.profiler: exactly one device operation
    a call."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    ties = 0
    for nch, nbins, weighted in ((1, 10, False), (8, 10, False),
                                 (32, 10, False), (1, 1000, False),
                                 (8, 1000, False), (32, 1000, False),
                                 (1, 10, True), (8, 10, True),
                                 (32, 10, True), (8, 1000, True)):
        hs, x = b1_edge_layout(torch, kernels, nbins, weighted, 3)
        th = b1_edge_thetas(torch, nch, 40 + nch)
        fn = (kernels.segmented_histogram if nch == 1
              else kernels.segmented_histogram_batched)
        got = fn(hs, x, th)
        want = kernels.segmented_histogram_plain(hs, x, th)
        ties += b1_equal(torch, got, want, weighted,
                         f"B1 edge layout, {nch} chain(s), {nbins} bins")
        slots = hs._b1[(nch, x.device.index)][1]
        if nbins == 1000 and nch > 1:
            check(slots == 0, f"B1 {nch} x 1000 bins: {slots} slots, "
                  "expected every count a global atomic")
    calls = []
    for k in range(3):
        for nbins, weighted, nch in ((10, False, 1), (1000, False, 8),
                                     (10, True, 8), (1000, True, 1),
                                     (10, False, 32)):
            hs, x = b1_edge_layout(torch, kernels, nbins, weighted, 10 + k)
            th = b1_edge_thetas(torch, nch, 7 * k + nch)
            fn = (kernels.segmented_histogram if nch == 1
                  else kernels.segmented_histogram_batched)
            calls.append((hs, x, th, weighted, fn(hs, x, th)))
        th = theta + 0.01 * k
        calls.append((st.hist_spec, st.samples, th, False,
                      kernels.segmented_histogram(st.hist_spec, st.samples,
                                                  th)))
    for hs, x, th, weighted, got in calls:
        ties += b1_equal(torch, got, kernels.segmented_histogram_plain(
            hs, x, th), weighted, "B1 back to back")
    del calls
    print(f"B1 edge layouts (offsets and n not multiples of 4, an empty "
          f"segment; 1, 8, 32 chains; unweighted and weighted; shared slots "
          f"and global atomics) and {3 * 6} calls back to back: equal to the "
          f"plain version ({ties} weighted values on rounding ties)")
    thetas = theta + 0.01 * torch.arange(NCHAINS, device=dev)[:, None]
    kernels.segmented_histogram_batched(st.hist_spec, st.samples, thetas)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kernels.segmented_histogram_batched(st.hist_spec, st.samples, thetas)
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    check(len(ops) == 1 and "sx_hist_kernel" in ops[0],
          f"a B1 call showed {len(ops)} device operations: {ops}")
    print(f"B1 call on the card: one device operation ({ops[0][:60]}), no "
          "memset")
    return ties


def check_kernels(torch, kernels, config_path: str, workdir: str):
    """Phase 3: each kernel and form against its plain version."""
    from sxmc_tpu_torch.fitconfig import FitConfig
    from sxmc_tpu_torch.generator import make_fake_dataset
    from sxmc_tpu_torch.mcmc.metropolis import (MCMC, initial_state,
                                                retune_scale_tril)
    from sxmc_tpu_torch.ops.transforms import SHIFT, SystematicDesc
    from sxmc_tpu_torch.pdf.evalhist import EvalHist
    from sxmc_tpu_torch.signal import nominal_params

    dev = torch.device("cuda")
    out = {}
    f4 = 4.0  # bytes per float32 / int32

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
    sample_bytes = sample_bytes_read(hs)
    hist_names = ("sx_hist_kernel",)
    dms = device_ms(torch, lambda: kernels.segmented_histogram(
        hs, st.samples, theta), 50, hist_names)
    print(f"B1 segmented_histogram, {hs.ndyn} x {hs.n // hs.ndyn} samples, "
          f"{hs.total} bins: counts and norms equal; kernel {ms:.4f} ms "
          f"(on the card {dms} ms), plain {plain_ms:.4f} ms")
    b1 = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
          "device_ms": dms,
          **bound(sample_bytes + f4 * hs.ndyn * (hs.total + 1),
                  binning_ops(hs))}
    b1["forms"] = b1_form("one theta, 2 x 500k, 10 bins", ms, dms,
                          bound(sample_bytes + f4 * hs.ndyn * (hs.total + 1),
                                binning_ops(hs)))

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
    b10 = bound(f4 * n + f4 * 1001, binning_ops(hs10))
    dms10 = device_ms(torch, lambda: kernels.segmented_histogram(
        hs10, x, th10), 20, hist_names)
    print(f"B1 segmented_histogram, 1 x {n} samples, 1000 bins, shift: "
          f"counts and norms equal; kernel {ms10:.4f} ms ({n / ms10 * 1e3:.4g} "
          f"samples/s; on the card {dms10} ms), plain {plain10:.4f} ms, "
          f"bound {b10['bound_ms']:.4f} ms ({b10['bound_by']})")
    b1.update(headline_ms=ms10, headline_plain_ms=plain10,
              headline_device_ms=dms10,
              headline_bound_ms=b10["bound_ms"],
              headline_samples_per_s=n / ms10 * 1e3)
    b1["forms"].update(b1_form("one theta, 10M, 1,000 bins", ms10, dms10,
                               b10))
    # The same rows for 8 chains (the binning of one field, batched).
    th8 = th10 + 0.001 * torch.arange(NCHAINS, device=dev)[:, None]
    check(all(torch.equal(g, w) for g, w in zip(
        kernels.segmented_histogram_batched(hs10, x, th8),
        kernels.segmented_histogram_plain(hs10, x, th8))),
        "B1-batched 10M-sample counts or norms differ")
    out["segmented_histogram"] = b1
    del x

    # B1-batched: 8 chains on the slice's layout, theta around nominal.
    gen = torch.Generator(dev).manual_seed(5)
    thetas = (theta + 0.01 * torch.randn((NCHAINS, theta.shape[0]),
                                         generator=gen, device=dev))
    got = kernels.segmented_histogram_batched(hs, st.samples, thetas)
    want = kernels.segmented_histogram_plain(hs, st.samples, thetas)
    torch.cuda.synchronize()
    err = float((got[0] - want[0]).abs().max())
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"B1-batched counts or norms differ (max {err})")
    ms, plain_ms = in_turns(
        torch, lambda: kernels.segmented_histogram_plain(hs, st.samples,
                                                         thetas),
        lambda: kernels.segmented_histogram_batched(hs, st.samples, thetas),
        3, 50)
    dms = device_ms(torch, lambda: kernels.segmented_histogram_batched(
        hs, st.samples, thetas), 50, hist_names)
    bb8 = bound(sample_bytes + f4 * NCHAINS * hs.ndyn * (hs.total + 1),
                binning_ops(hs, NCHAINS))
    out["segmented_histogram_batched"] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "device_ms": dms, **bb8,
        "forms": b1_form("8 chains, 2 x 500k", ms, dms, bb8)}
    print(f"B1 segmented_histogram_batched, {NCHAINS} chains: counts and "
          f"norms equal; kernel {ms:.4f} ms (on the card {dms} ms), plain "
          f"{plain_ms:.4f} ms")
    out["segmented_histogram"]["edge_tie_values"] = check_b1_edges(
        torch, kernels, st, theta)

    # A fake dataset: the example's read bins.
    data = make_fake_dataset(torch.Generator().manual_seed(3), fc.signals,
                             fc.systematics, fc.observables, stack=st)
    st.set_data(data)
    rb = st.read_bins
    nsig, nev = rb.shape

    # B2 at the example shape (the fixed-systematics path's LUT).
    hists, norms = st.histograms(theta)
    got = kernels.lut_eval(hists, norms, rb, st.bin_volume)
    want = kernels.lut_eval_plain(hists, norms, rb, st.bin_volume)
    torch.cuda.synchronize()
    err = lut_equal(torch, got, want)
    ms, plain_ms = in_turns(
        torch, lambda: kernels.lut_eval_plain(hists, norms, rb,
                                              st.bin_volume),
        lambda: kernels.lut_eval(hists, norms, rb, st.bin_volume), 20, 200)
    flat = hists.reshape(-1)
    idx = (torch.arange(nsig, device=dev)[:, None] * hs.total
           + rb.clamp(0, hs.total - 1).to(torch.int64)).reshape(-1)
    lib_ms = cuda_ms(torch, lambda: torch.gather(flat, 0, idx), 200)
    lut_names = ("sx_eval_lut_kernel",)
    dms = device_ms(torch, lambda: kernels.lut_eval(
        hists, norms, rb, st.bin_volume), 50, lut_names)
    b2 = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
          "library_ms": lib_ms, "device_ms": dms,
          **bound(f4 * (nsig * hs.total + nsig + 2 * nsig * nev),
                  2.0 * nsig * nev)}
    print(f"B2 lut_eval, {nsig} x {nev} events, {hs.total} bins: values "
          f"equal; kernel {ms:.4f} ms (on the card {dms} ms), plain "
          f"{plain_ms:.4f} ms, torch.gather {lib_ms:.4f} ms")

    # B2 at 2 signals x 1M events x 1000 bins.
    big_n, big_total = 1_000_000, 1000
    gen = torch.Generator(dev).manual_seed(9)
    cnt = torch.randint(0, 5000, (2, big_total), generator=gen,
                        device=dev).to(torch.float32)
    nrm = cnt.sum(dim=1)
    rbb = torch.randint(-2, big_total, (2, big_n), generator=gen,
                        device=dev, dtype=torch.int32)
    got = kernels.lut_eval(cnt, nrm, rbb, 0.01)
    want = kernels.lut_eval_plain(cnt, nrm, rbb, 0.01)
    torch.cuda.synchronize()
    lut_equal(torch, got, want)
    msb, plainb = in_turns(
        torch, lambda: kernels.lut_eval_plain(cnt, nrm, rbb, 0.01),
        lambda: kernels.lut_eval(cnt, nrm, rbb, 0.01), 5, 50)
    flatb = cnt.reshape(-1)
    idxb = (torch.arange(2, device=dev)[:, None] * big_total
            + rbb.clamp(0, big_total - 1).to(torch.int64)).reshape(-1)
    libb = cuda_ms(torch, lambda: torch.gather(flatb, 0, idxb), 50)
    bb = bound(f4 * (2 * big_total + 2 + 4 * big_n), 4.0 * big_n)
    dmsb = device_ms(torch, lambda: kernels.lut_eval(cnt, nrm, rbb, 0.01),
                     20, lut_names)
    dlibb = device_ms(torch, lambda: torch.gather(flatb, 0, idxb), 20,
                      ("gather",))
    b2.update(headline_ms=msb, headline_plain_ms=plainb,
              headline_library_ms=libb, headline_bound_ms=bb["bound_ms"],
              headline_device_ms=dmsb, headline_library_device_ms=dlibb)
    print(f"B2 lut_eval, 2 x {big_n} events, {big_total} bins: values "
          f"equal; kernel {msb:.4f} ms (on the card {dmsb} ms), plain "
          f"{plainb:.4f} ms, torch.gather {libb:.4f} ms (on the card "
          f"{dlibb} ms), bound {bb['bound_ms']:.4f} ms ({bb['bound_by']})")
    del cnt, rbb, idxb

    # EvalHist.eval (B1 with one segment, then B2) on signal1's rows.
    sig = fc.signals[0].histogram
    ev = EvalHist(sig.samples_host, sig.nfields, sig.nobservables,
                  sig.lower_host, sig.upper_host, sig.nbins,
                  dataset=sig.dataset, device=dev)
    for d in sig.systematics:
        ev.add_systematic(d)
    ev_rb = ev.compute_read_bins(data)
    ev_theta = [0.004, -0.0007]
    ev_th = torch.as_tensor(ev_theta, device=dev)
    got, got_norm = ev.eval(ev_rb, ev_theta)
    pb, pn = kernels.segmented_histogram_plain(ev.hist_spec(),
                                               ev.device_samples(), ev_th)
    want = kernels.lut_eval_plain(pb, pn, ev_rb[None], ev.bin_volume)[0]
    torch.cuda.synchronize()
    check(float(got_norm) == float(pn[0]), "EvalHist.eval norms differ")
    lut_equal(torch, got, want)
    print(f"EvalHist.eval, {ev.n_mc} rows, {ev_rb.shape[0]} points: values "
          f"and norm equal (B1 + B2)")

    # B1a: EvalHist.histogram (B1 with one segment) on the same rows.
    ev_hs = ev.hist_spec()
    got, got_norm = ev.histogram(ev_theta)
    torch.cuda.synchronize()
    check(torch.equal(got, pb[0]) and float(got_norm) == float(pn[0]),
          "EvalHist.histogram differs from its plain version")
    ms, plain_ms = in_turns(
        torch, lambda: kernels.segmented_histogram_plain(
            ev_hs, ev.device_samples(), ev_th),
        lambda: ev.histogram(ev_theta), 5, 50)
    dms = device_ms(torch, lambda: ev.histogram(ev_theta), 50, hist_names)
    b1a = bound(sample_bytes_read(ev_hs) + f4 * (ev_hs.total + 1),
                binning_ops(ev_hs))
    out["segmented_histogram"]["forms"].update(
        b1_form("B1a, 500k, 10 bins", ms, dms, b1a))
    print(f"B1a EvalHist.histogram, {ev_hs.n} rows, {ev_hs.total} bins: "
          f"counts and norm equal; kernel {ms:.4f} ms (on the card {dms} "
          f"ms), plain {plain_ms:.4f} ms, bound {b1a['bound_ms']:.4f} ms "
          f"({b1a['bound_by']})")

    # B3 at the nominal and at a perturbed point.
    ns = mcmc.nll_spec
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
    b3_bytes = sample_bytes + f4 * (nsig * hs.total + nsig * nev)
    fused_names = ("sx_fused_kernel",)
    dms = device_ms(torch, lambda: kernels.fused_nll(
        hs, ns, st.samples, st.hist_init, rb, p1), 50, fused_names)
    print(f"B3 fused_nll, {nev} events: |dNLL| {err:.3g} <= "
          f"{NLL_TOL}; kernel {ms:.4f} ms (on the card {dms} ms), plain "
          f"{plain_ms:.4f} ms")
    out["fused_nll"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "device_ms": dms,
                        **bound(b3_bytes, binning_ops(hs)
                                + event_ops(nsig, nev))}

    # B3-batched: 8 chains around the nominal point.
    pc = p0 + 0.02 * torch.randn((NCHAINS, p0.shape[0]), generator=gen,
                                 device=dev) * torch.as_tensor(
        [1.0, 1.0, 0.1, 0.01], device=dev)
    hi, lo = kernels.fused_nll_batched(hs, ns, st.samples, st.hist_init,
                                       rb, pc)
    phi, plo = kernels.fused_nll_plain(hs, ns, st.samples, st.hist_init,
                                       rb, pc)
    err = float((hi.double() + lo.double() - phi.double()
                 - plo.double()).abs().max())
    check(err <= NLL_TOL, f"B3-batched NLL differs by {err}")
    ms, plain_ms = in_turns(
        torch, lambda: kernels.fused_nll_plain(hs, ns, st.samples,
                                               st.hist_init, rb, pc),
        lambda: kernels.fused_nll_batched(hs, ns, st.samples, st.hist_init,
                                          rb, pc), 3, 50)
    dms = device_ms(torch, lambda: kernels.fused_nll_batched(
        hs, ns, st.samples, st.hist_init, rb, pc), 50, fused_names)
    print(f"B3 fused_nll_batched, {NCHAINS} chains: |dNLL| {err:.3g}; "
          f"kernel {ms:.4f} ms (on the card {dms} ms), plain "
          f"{plain_ms:.4f} ms")
    out["fused_nll_batched"] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "device_ms": dms,
        **bound(b3_bytes, NCHAINS * (binning_ops(hs)
                                     + event_ops(nsig, nev)))}

    # B4: a 500-step segment fed identical noise, then 8 chains.
    for name, nch in (("fused_segment", 1), ("fused_segment_batched",
                                             NCHAINS)):
        params, nll0, width = initial_state(mcmc, rb, nch)
        nll0 = torch.stack(nll0, dim=-1)
        gen = torch.Generator(dev).manual_seed(11)
        lead = (SEGMENT_STEPS,) if nch == 1 else (SEGMENT_STEPS, nch)
        noise = torch.randn(lead + (mcmc.nparameters,), generator=gen,
                            device=dev)
        log_u = torch.log(torch.rand(lead, generator=gen, device=dev))
        args = (hs, ns, st.samples, st.hist_init, rb, params, nll0, width,
                noise, log_u)
        kern = getattr(kernels, name)
        s, nl, a = kern(*args)
        ps, pnl, pa = kernels.fused_segment_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(a, pa), f"{name}: accept decisions differ")
        check(torch.equal(s, ps), f"{name}: parameter trajectories differ")
        err = float((nl.double().sum(-1) - pnl.double().sum(-1)).abs().max())
        check(err <= NLL_TOL, f"{name}: NLL history differs by {err}")
        ms, plain_ms = in_turns(
            torch, lambda: kernels.fused_segment_plain(*args),
            lambda: kern(*args), 1, 10)
        seg_bytes = (sample_bytes + f4 * (nsig * hs.total + nsig * nev)
                     + f4 * SEGMENT_STEPS * nch * (2 * mcmc.nparameters + 4))
        print(f"B4 {name}, {nch} chain(s) x {SEGMENT_STEPS} steps: "
              f"trajectories identical (accept rate {float(a.mean()):.3f}), "
              f"|dNLL| {err:.3g}; kernel {ms:.4f} ms "
              f"({ms / SEGMENT_STEPS * 1e3:.2f} us/step), plain "
              f"{plain_ms:.4f} ms")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     **bound(seg_bytes, SEGMENT_STEPS * nch * (
                         binning_ops(hs) + event_ops(nsig, nev)))}

    # B4-tril: the same segments with correlated lower-triangular scales.
    npar = mcmc.nparameters
    for name, nch in (("fused_segment_tril", 1),
                      ("fused_segment_tril_batched", NCHAINS)):
        params, nll0, width = initial_state(mcmc, rb, nch)
        nll0 = torch.stack(nll0, dim=-1)
        w = width.clamp_min(0.0)
        tril = torch.diag_embed(w) + 0.3 * torch.tril(
            torch.ones((npar, npar), device=dev), -1) * w[..., :, None]
        tril = tril.contiguous()
        gen = torch.Generator(dev).manual_seed(13)
        lead = (SEGMENT_STEPS,) if nch == 1 else (SEGMENT_STEPS, nch)
        noise = torch.randn(lead + (npar,), generator=gen, device=dev)
        log_u = torch.log(torch.rand(lead, generator=gen, device=dev))
        args = (hs, ns, st.samples, st.hist_init, rb, params, nll0, tril,
                noise, log_u)
        kern = getattr(kernels, name)
        s, nl, a = kern(*args)
        ps, pnl, pa = kernels.fused_segment_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(a, pa), f"{name}: accept decisions differ")
        check(torch.equal(s, ps), f"{name}: parameter trajectories differ")
        check(0 < float(a.sum()) < a.numel(), f"{name}: no walk ({a.mean()})")
        err = float((nl.double().sum(-1) - pnl.double().sum(-1)).abs().max())
        check(err <= NLL_TOL, f"{name}: NLL history differs by {err}")
        ms, plain_ms = in_turns(
            torch, lambda: kernels.fused_segment_plain(*args),
            lambda: kern(*args), 1, 10)
        seg_bytes = (sample_bytes + f4 * (nsig * hs.total + nsig * nev)
                     + f4 * nch * npar * npar
                     + f4 * SEGMENT_STEPS * nch * (2 * npar + 4))
        print(f"B4 {name}, {nch} chain(s) x {SEGMENT_STEPS} steps: "
              f"trajectories identical (accept rate {float(a.mean()):.3f}), "
              f"|dNLL| {err:.3g}; kernel {ms:.4f} ms "
              f"({ms / SEGMENT_STEPS * 1e3:.2f} us/step), plain "
              f"{plain_ms:.4f} ms")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     **bound(seg_bytes, SEGMENT_STEPS * nch * (
                         binning_ops(hs) + event_ops(nsig, nev)
                         + npar * (npar + 1)))}
        if nch == 1:
            # The full_cov retune between phases: the process's first
            # Cholesky on the card, then a warm one.
            t0 = time.perf_counter()
            retune_scale_tril(mcmc, tril, s)
            torch.cuda.synchronize()
            first = (time.perf_counter() - t0) * 1e3
            warm = cuda_ms(torch, lambda: retune_scale_tril(mcmc, tril, s),
                           20)
            print(f"retune_scale_tril ({SEGMENT_STEPS} samples): first call "
                  f"{first:.2f} ms, then {warm:.4f} ms")

    # B5: SEGMENT_STEPS blocked cycles of 1 + RATE_SUBSTEPS decisions.
    nsub = RATE_SUBSTEPS + 1
    for name, nch in (("blocked_segment", 1),
                      ("blocked_segment_batched", NCHAINS)):
        params, nll0, width = initial_state(mcmc, rb, nch)
        nll0 = torch.stack(nll0, dim=-1)
        gen = torch.Generator(dev).manual_seed(17)
        lead = (SEGMENT_STEPS, nsub) + ((nch,) if nch > 1 else ())
        noise = torch.randn(lead + (npar,), generator=gen, device=dev)
        log_u = torch.log(torch.rand(lead, generator=gen, device=dev))
        args = (hs, ns, st.samples, st.hist_init, rb, params, nll0, width,
                noise, log_u)
        kern = getattr(kernels, name)
        s, nl, a = kern(*args)
        ps, pnl, pa = kernels.blocked_segment_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(a, pa), f"{name}: accepted fractions differ")
        check(torch.equal(s, ps), f"{name}: parameter trajectories differ")
        check(0 < float(a.sum()) < a.numel(), f"{name}: no walk ({a.mean()})")
        err = float((nl.double().sum(-1) - pnl.double().sum(-1)).abs().max())
        check(err <= NLL_TOL, f"{name}: NLL history differs by {err}")
        ms, plain_ms = in_turns(
            torch, lambda: kernels.blocked_segment_plain(*args),
            lambda: kern(*args), 1, 10)
        # M = 1 on the same cycles: what RATE_SUBSTEPS - 1 rate moves add.
        args1 = args[:8] + (noise[:, :2].contiguous(),
                            log_u[:, :2].contiguous())
        ms1 = cuda_ms(torch, lambda: kern(*args1), 10)
        per_rate = (ms - ms1) / (RATE_SUBSTEPS - 1) / SEGMENT_STEPS * 1e3
        seg_bytes = (sample_bytes + f4 * (nsig * hs.total + nsig * nev)
                     + f4 * SEGMENT_STEPS * nch * (nsub * (npar + 1)
                                                   + npar + 3))
        print(f"B5 {name}, {nch} chain(s) x {SEGMENT_STEPS} cycles x "
              f"{nsub} decisions: trajectories identical (accepted "
              f"fraction {float(a.mean()):.3f}), |dNLL| {err:.3g}; kernel "
              f"{ms:.4f} ms ({ms / SEGMENT_STEPS * 1e3:.2f} us/cycle; "
              f"M = 1: {ms1 / SEGMENT_STEPS * 1e3:.2f} us/cycle, so "
              f"{per_rate:.2f} us per rate move), plain {plain_ms:.4f} ms")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "ms_m1": ms1, "us_per_rate_move": per_rate,
                     **bound(seg_bytes, SEGMENT_STEPS * nch * (
                         binning_ops(hs) + nsub * event_ops(nsig, nev)))}
    out["lut_eval"] = b2

    # B4-tempered: a ladder of NTEMPS replicas, widened by 1/sqrt(beta).
    from sxmc_tpu_torch.mcmc.tempered import temperature_ladder

    beta = torch.as_tensor(temperature_ladder(NTEMPS, TMAX), device=dev)
    params, nll0, width = initial_state(mcmc, rb, NTEMPS)
    gen = torch.Generator(dev).manual_seed(19)
    noise = torch.randn((SEGMENT_STEPS, NTEMPS, npar), generator=gen,
                        device=dev)
    log_u = torch.log(torch.rand((SEGMENT_STEPS, NTEMPS), generator=gen,
                                 device=dev))
    t_args = (params, torch.stack(nll0, dim=-1),
              width / torch.sqrt(beta)[:, None])
    out["fused_segment_tempered"] = check_tempered(
        torch, kernels, "fused_segment_tempered", hs, ns, st, rb, t_args,
        beta, noise, log_u, sample_bytes, nsig, nev)

    check_regimes(torch, kernels, config_path, workdir, data, out)
    check_weighted(torch, kernels, config_path, workdir, data, out, beta,
                   noise, log_u)
    check_grouped(torch, kernels, config_path, workdir, out)
    for v in out.values():
        v.setdefault("library_ms", None)
    return out


def write_example_variant(config_path: str, workdir: str, bins: int = 0,
                          wide: bool = False) -> str:
    """The example's configuration with ``bins`` energy bins, or (wide)
    with radius as a second observable (no cut) and two more
    systematics, loaded in the order radius resolution (it appends
    mc_energy to the sample fields), a shift of mc_energy, then the
    energy scale and resolution: the binning's general case, two
    observables and a transformed truth field that both resolutions
    read.  Returns the new file's path."""
    with open(config_path) as f:
        cfg = json.load(f)
    if bins:
        cfg["pdfs"]["observables"]["energy"]["bins"] = bins
    if wide:
        cfg["fit"].update(observables=["energy", "radius"], cuts=[])
        systs = cfg["pdfs"]["systematics"]
        systs["radius_resolution"] = {
            "title": "Radius resolution", "type": "resolution_scale",
            "observable_field": "radius", "true_field": "mc_energy",
            "mean": [0.0], "sigma": [1e-3]}
        systs["truth_shift"] = {
            "title": "True energy shift", "type": "shift",
            "observable_field": "mc_energy", "mean": [0.0],
            "sigma": [0.5]}
        for sig in cfg["signals"].values():
            sig["systematics"] = ["radius_resolution", "truth_shift"] + \
                sig["systematics"]
    path = os.path.join(workdir, f"example_{bins}_{int(wide)}.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


def example_mcmc(torch, path: str, workdir: str, data=None):
    """(MCMC on the card, its data): the configuration at ``path`` with
    ``data``, or a fake dataset drawn from seed 3."""
    from sxmc_tpu_torch.fitconfig import FitConfig
    from sxmc_tpu_torch.generator import make_fake_dataset
    from sxmc_tpu_torch.mcmc.metropolis import MCMC

    fc = FitConfig.from_json_file(path, data_root=workdir)
    mcmc = MCMC(fc.sources, fc.signals, fc.systematics, fc.observables,
                device=torch.device("cuda"))
    if data is None:
        data = make_fake_dataset(torch.Generator().manual_seed(3),
                                 fc.signals, fc.systematics, fc.observables,
                                 stack=mcmc.stack)
    mcmc.stack.set_data(data)
    return mcmc, data


def segment_args(torch, mcmc, nch: int, seed: int, sub=()):
    """The arguments of a B4 (or, with ``sub`` = (M + 1,), B5) segment of
    SEGMENT_STEPS steps for 1 or ``nch`` chains from their start, with
    streams drawn on the card from ``seed``."""
    from sxmc_tpu_torch.mcmc.metropolis import initial_state

    dev = torch.device("cuda")
    st = mcmc.stack
    params, nll0, width = initial_state(mcmc, st.read_bins, nch)
    gen = torch.Generator(dev).manual_seed(seed)
    lead = (SEGMENT_STEPS,) + tuple(sub) + ((nch,) if nch > 1 else ())
    noise = torch.randn(lead + (mcmc.nparameters,), generator=gen,
                        device=dev)
    log_u = torch.log(torch.rand(lead, generator=gen, device=dev))
    return (st.hist_spec, mcmc.nll_spec, st.samples, st.hist_init,
            st.read_bins, params, torch.stack(nll0, dim=-1), width, noise,
            log_u)


def far_example_mcmc(torch, workdir: str, weighted: bool = False):
    """MCMC on the card for the example's two signals with the true
    energy carried as sample field 4, behind three copies of the radius
    (sample fields energy, radius, radius2, radius3, mc_energy, DATASET),
    and a shift of it (sigma 0.5) ahead of the energy scale and
    resolution: a systematic transforms field 4 (nload = 5), which the
    kernels bin with every field in registers.  No cut; the data a fake
    dataset drawn from seed 3.  ``weighted``: log-normal (sigma
    WEIGHT_SIGMA) float32 weights per MC row, drawn from a seed."""
    from sxmc_tpu_torch.generator import make_fake_dataset
    from sxmc_tpu_torch.io import loaders
    from sxmc_tpu_torch.mcmc.metropolis import MCMC
    from sxmc_tpu_torch.signal import Observable, Signal, Source, Systematic

    obs = [Observable(name="energy", field="energy", bins=10, lower=5.0,
                      upper=15.0, field_index=0)]
    systs = [Systematic(name="truth_shift", type=0,
                        observable_field="mc_energy", means=[0.0],
                        sigmas=[0.5], observable_field_index=4, pidx=[0]),
             Systematic(name="energy_scale", type=1, observable_field="energy",
                        means=[0.0], sigmas=[1e-2],
                        observable_field_index=0, pidx=[1]),
             Systematic(name="energy_resolution", type=2,
                        observable_field="energy", truth_field="mc_energy",
                        means=[0.0], sigmas=[1e-3], observable_field_index=0,
                        truth_field_index=4, pidx=[2])]
    sample_fields = ["energy", "radius", "radius2", "radius3", "mc_energy",
                     "DATASET"]
    srcs, sigs = [], []
    for j, (name, nexp, sigma) in enumerate((("signal1", 1000.0, 0.05),
                                             ("signal2", 500.0, 0.0))):
        table, fields = loaders.read_float_table(
            os.path.join(workdir, f"{name}.npz"))
        radius = table[:, fields.index("radius")]
        data = np.concatenate([table, radius[:, None], radius[:, None]], 1)
        srcs.append(Source(name=name, index=j, mean=1.0, sigma=sigma))
        sigs.append(Signal.from_table(
            name, name, data, list(fields) + ["radius2", "radius3"], 0,
            srcs[j], nexp, sample_fields, obs, [], systs))
    if weighted:
        rng = np.random.default_rng(29)
        for sig in sigs:
            sig.histogram.weights = rng.lognormal(
                0.0, WEIGHT_SIGMA, sig.n_mc).astype(np.float32)
    mcmc = MCMC(srcs, sigs, systs, obs, device=torch.device("cuda"))
    check(mcmc.stack.hist_spec.nload == 5,
          f"far example: nload {mcmc.stack.hist_spec.nload}, expected 5")
    mcmc.stack.set_data(make_fake_dataset(
        torch.Generator().manual_seed(3), sigs, systs, obs,
        stack=mcmc.stack))
    return mcmc


def check_layout_b1_b3(torch, kernels, mcmc, tag: str):
    """B1 (one theta and batched) and B3 (one chain and batched) on the
    wide or a far layout, each against its plain version: counts and norms equal
    (weighted: but on a counted rounding tie), |dNLL| <= NLL_TOL.
    Systematic parameters drawn at their prior widths."""
    st = mcmc.stack
    hs, ns = st.hist_spec, mcmc.nll_spec
    dev = st.samples.device
    nsrc = int(ns.st.nsources)
    widths = torch.as_tensor(np.asarray(ns.st.sigmas[nsrc:], np.float32),
                             device=dev)
    gen = torch.Generator(dev).manual_seed(5)
    th = widths * torch.randn((NCHAINS, widths.shape[0]), generator=gen,
                              device=dev)
    got = kernels.segmented_histogram_batched(hs, st.samples, th)
    want = kernels.segmented_histogram_plain(hs, st.samples, th)
    one = kernels.segmented_histogram(hs, st.samples, th[1])
    torch.cuda.synchronize()
    if hs.weighted:
        ties = sum(equal_but_ties(torch, g, w, f"B1-batched ({tag})")
                   + equal_but_ties(torch, o, w[1], f"B1 ({tag})")
                   for g, w, o in zip(got, want, one))
    else:
        ties = 0
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"B1-batched ({tag}) counts or norms differ")
        check(all(torch.equal(w[1], o) for w, o in zip(want, one)),
              f"B1 ({tag}) counts or norms differ")
    p0 = torch.as_tensor(mcmc.parameter_means, device=dev)
    pc = p0 + torch.cat([0.02 * torch.randn((NCHAINS, nsrc), generator=gen,
                                            device=dev),
                         th], dim=1)
    errs = []
    for p, fn in ((p0, kernels.fused_nll), (pc[1], kernels.fused_nll),
                  (pc, kernels.fused_nll_batched)):
        hi, lo = fn(hs, ns, st.samples, st.hist_init, st.read_bins, p)
        phi, plo = kernels.fused_nll_plain(hs, ns, st.samples, st.hist_init,
                                           st.read_bins, p)
        errs.append(float((hi.double() + lo.double() - phi.double()
                           - plo.double()).abs().max()))
    err = max(errs)
    check(err <= NLL_TOL, f"B3 ({tag}) NLL differs by {err} > {NLL_TOL}")
    print(f"B1 segmented_histogram and _batched ({tag}), {NCHAINS} chains, "
          f"{hs.nobs} observable(s) x {hs.total} bins, {hs.nfields} fields, "
          f"nload {hs.nload}: counts and norms equal"
          + (f" but {ties} rounding tie(s)" if hs.weighted else "")
          + f"; B3 fused_nll and _batched: |dNLL| {err:.3g} <= {NLL_TOL}")


def check_regimes(torch, kernels, config_path, workdir, data, out):
    """The lock-step rebuild's regimes, each against its plain version
    (decisions and parameters identical, |dNLL| <= NLL_TOL) and timed:
    B4-batched at MAXCHAINS chains (the most one launch takes; every
    chain's histograms in the shared-memory replicas) on the example,
    and at NCHAINS chains at 1,000 energy bins (too large for the
    replicas: every count a global atomic); B1 (one theta and batched,
    counts bit-exact), B4-batched and B5-batched at NCHAINS chains on
    the wide example (two observables, a transformed truth field), with
    B1 and B3 (check_layout_b1_b3); and on the far one (far_example_mcmc:
    a transformed field 4, the forms that bin every field in registers)
    B1 and B3, B4
    one chain (diagonal and tril), B5 one chain, B4- and B5-batched, and
    weighted, B1, B3 and B4-batched."""
    path_1000 = write_example_variant(config_path, workdir, bins=1000)
    path_wide = write_example_variant(config_path, workdir, wide=True)
    nsub = (RATE_SUBSTEPS + 1,)
    far, far_w = "far", "far weighted"
    res = {}
    mcmcs = {}
    for tag, path, name, nch, sub in (
            ("maxchains", config_path, "fused_segment_batched",
             kernels.MAXCHAINS, ()),
            ("bins1000", path_1000, "fused_segment_batched", NCHAINS, ()),
            ("wide", path_wide, "fused_segment_batched", NCHAINS, ()),
            ("wide", path_wide, "blocked_segment_batched", NCHAINS, nsub),
            (far, far, "fused_segment", 1, ()),
            (far, far, "fused_segment_tril", 1, ()),
            (far, far, "blocked_segment", 1, nsub),
            (far, far, "fused_segment_batched", NCHAINS, ()),
            (far, far, "blocked_segment_batched", NCHAINS, nsub),
            (far_w, far_w, "fused_segment_batched", NCHAINS, ())):
        if path not in mcmcs:
            if path in (far, far_w):
                mcmcs[path] = far_example_mcmc(torch, workdir,
                                               weighted=path == far_w)
                check_layout_b1_b3(torch, kernels, mcmcs[path], tag)
            else:
                mcmcs[path] = example_mcmc(
                    torch, path, workdir,
                    data if path != path_wide else None)[0]
                if path == path_wide:
                    check_layout_b1_b3(torch, kernels, mcmcs[path], tag)
        mcmc = mcmcs[path]
        st = mcmc.stack
        hs = st.hist_spec
        args = segment_args(torch, mcmc, nch, 31, sub)
        if "tril" in name:
            # Correlated lower-triangular scales from the widths.
            w = args[7].clamp_min(0)
            low = torch.tril(torch.full(w.shape[-1:] * 2, 0.3,
                                        device=w.device), -1)
            args = args[:7] + ((torch.diag_embed(w) + low * w[..., :, None])
                               .contiguous(),) + args[8:]
        kern = getattr(kernels, name)
        plain = (kernels.blocked_segment_plain if sub
                 else kernels.fused_segment_plain)
        got = kern(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        label = f"{name} ({tag})"
        err = same_walk(torch, label, got, want)
        check(0 < float(got[2].sum()) < got[2].numel(),
              f"{label}: no walk ({float(got[2].mean())})")
        ms = cuda_ms(torch, lambda: kern(*args), 10)
        us = ms / SEGMENT_STEPS * 1e3
        unit = "cycle" if sub else "step"
        # The bound as the main rows take it: samples and tables read
        # once, the histories written once; per step (cycle) a binning of
        # every sample per chain and one event sweep per decision.
        nsig, nev = mcmc.nsignals, st.read_bins.shape[1]
        npar, ndec = mcmc.nparameters, sub[0] if sub else 1
        bnd = bound(sample_bytes_read(hs) + 4.0 * (
            nsig * hs.total + nsig * nev + SEGMENT_STEPS * nch * (
                ndec * (npar + 1) + npar + 3)),
            SEGMENT_STEPS * nch * (binning_ops(hs)
                                   + ndec * event_ops(nsig, nev)))
        print(f"{'B5' if sub else 'B4'} {label}, {nch} chains x "
              f"{SEGMENT_STEPS} {unit}s, {hs.total} bins: trajectories "
              f"identical (accept rate {float(got[2].mean()):.3f}), |dNLL| "
              f"{err:.3g}; kernel {ms:.4f} ms ({us:.2f} us/{unit}), bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        res[f"{name} {tag}"] = {"nchains": nch, "bins": hs.total,
                                "max_abs_err": err, "ms": ms,
                                f"us_per_{unit}": us, **bnd}
    out["fused_segment_batched"]["regimes"] = res


def check_tempered(torch, kernels, name, hs, ns, st, rb, t_args, beta,
                   noise, log_u, sample_bytes, nsig, nev):
    """B4-tempered (``name``: its unweighted or weighted form) against
    its plain version, timed."""
    f4 = 4.0
    args = (hs, ns, st.samples, st.hist_init, rb) + t_args + (beta, noise,
                                                              log_u)
    got = kernels.fused_segment_tempered(*args)
    want = kernels.fused_segment_plain(*args[:8], noise, log_u, beta=beta)
    torch.cuda.synchronize()
    err = same_walk(torch, name, got, want)
    a = got[2]
    check(0 < float(a.sum()) < a.numel(), f"{name}: no walk")
    ms, plain_ms = in_turns(
        torch, lambda: kernels.fused_segment_plain(*args[:8], noise, log_u,
                                                   beta=beta),
        lambda: kernels.fused_segment_tempered(*args), 1, 10)
    nch, npar = t_args[0].shape
    seg_bytes = (sample_bytes + f4 * (nsig * hs.total + nsig * nev)
                 + f4 * nch + f4 * SEGMENT_STEPS * nch * (2 * npar + 4))
    print(f"B4 {name}, {nch} replicas x {SEGMENT_STEPS} steps: "
          f"trajectories identical (accept rate by replica "
          f"{[round(x, 3) for x in a.mean(0).tolist()]}), |dNLL| "
          f"{err:.3g}; kernel {ms:.4f} ms ({ms / SEGMENT_STEPS * 1e3:.2f} "
          f"us/step), plain {plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **bound(seg_bytes, SEGMENT_STEPS * nch * (
                binning_ops(hs) + weight_ops(hs) + event_ops(nsig, nev)
                + 1))}


def check_weighted(torch, kernels, config_path, workdir, data, out, beta,
                   noise_t, log_u_t):
    """Phase 3, weighted: every weighted form against its plain version
    on the example with weighted signals."""
    from sxmc_tpu_torch.mcmc.metropolis import MCMC, initial_state
    from sxmc_tpu_torch.ops.transforms import SHIFT, SystematicDesc
    from sxmc_tpu_torch.pdf.evalhist import EvalHist
    from sxmc_tpu_torch.signal import nominal_params

    dev = torch.device("cuda")
    f4 = 4.0
    fc = weighted_fit(config_path, workdir)
    mcmc = MCMC(fc.sources, fc.signals, fc.systematics, fc.observables,
                device=dev)
    st = mcmc.stack
    hs, ns = st.hist_spec, mcmc.nll_spec
    check(hs.weighted, "the weighted stack's samples carry no weights")
    st.set_data(data)
    rb = st.read_bins
    nsig, nev = rb.shape
    npar = mcmc.nparameters
    sample_bytes = sample_bytes_read(hs)
    hist_names = ("sx_hist_kernel",)
    theta = torch.as_tensor(nominal_params(fc.systematics), device=dev)
    # The grid rule's blocks per SM with float64 replicas in shared
    # memory (twice the unsigned counts' bytes), beside the unweighted.
    lib = kernels._library()
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    for nch in (1, NCHAINS):
        grids = []
        for weighted in (0, 1):
            nb = ctypes.c_int(0)
            cs = kernels._c_spec(hs, ns, int(ns.st.nsources))
            kernels._check_cuda(lib, lib.sx_fused_grid(
                ctypes.byref(cs), nch, weighted, ctypes.byref(nb)),
                "sx_fused_grid")
            grids.append(nb.value // nsm)
        print(f"B4 grid rule, {nch} chain(s): {grids[0]} blocks per SM "
              f"unweighted, {grids[1]} weighted")

    def b1_check(name, hs_, x, th, nch, reps):
        fn = getattr(kernels, name)
        got = fn(hs_, x, th)
        want = kernels.segmented_histogram_plain(hs_, x, th)
        torch.cuda.synchronize()
        ties = (equal_but_ties(torch, got[0], want[0], f"{name} bins")
                + equal_but_ties(torch, got[1], want[1], f"{name} norms"))
        rel = float(((got[0] - want[0]).abs()
                     / want[0].abs().clamp_min(1e-30)).max())
        ms, plain_ms = in_turns(
            torch, lambda: kernels.segmented_histogram_plain(hs_, x, th),
            lambda: fn(hs_, x, th), 3, reps)
        dms = device_ms(torch, lambda: fn(hs_, x, th), reps, hist_names)
        print(f"B1 {name}_weighted, {nch} chain(s), {hs_.ndyn} x "
              f"{hs_.n // hs_.ndyn} samples, {hs_.total} bins: {ties} "
              f"bins or norms differ (rounding ties), max relative "
              f"difference {rel:.3g}; kernel {ms:.4f} ms (on the card "
              f"{dms} ms), plain {plain_ms:.4f} ms")
        return {"max_abs_err": float((got[0] - want[0]).abs().max()),
                "tie_bins": ties, "ms": ms, "plain_ms": plain_ms,
                "device_ms": dms,
                **bound(sample_bytes_read(hs_)
                        + f4 * nch * hs_.ndyn * (hs_.total + 1),
                        binning_ops(hs_, nch) + weight_ops(hs_, nch))}

    w1 = b1_check("segmented_histogram", hs, st.samples, theta, 1, 50)
    # B1 weighted at 10M samples, 1000 bins, one shift systematic.
    n = 10_000_000
    gen = torch.Generator(dev).manual_seed(29)
    x = torch.cat([torch.rand((1, n), generator=gen, device=dev) * 12.0
                   + 4.0, torch.exp(WEIGHT_SIGMA * torch.randn(
                       (1, n), generator=gen, device=dev))])
    hs10 = kernels.HistSpec.build(
        1, [5.0], [15.0], [1000],
        [(SystematicDesc(type=SHIFT, obs=0, par_indices=(0,)), (True,))],
        [0, n], weighted=True)
    w10 = b1_check("segmented_histogram", hs10, x, torch.as_tensor(
        [0.0137], device=dev), 1, 20)
    w1.update(headline_ms=w10["ms"], headline_plain_ms=w10["plain_ms"],
              headline_device_ms=w10["device_ms"],
              headline_bound_ms=w10["bound_ms"],
              headline_tie_bins=w10["tie_bins"])
    w1["forms"] = b1_form("weighted, 2 x 500k", w1["ms"], w1["device_ms"],
                          {k: w1[k] for k in ("bound_ms", "bound_by")})
    w1["forms"].update(b1_form(
        "weighted, 10M, 1,000 bins", w10["ms"], w10["device_ms"],
        {k: w10[k] for k in ("bound_ms", "bound_by")}))
    out["segmented_histogram_weighted"] = w1
    del x
    gen = torch.Generator(dev).manual_seed(31)
    thetas = theta + 0.01 * torch.randn((NCHAINS, theta.shape[0]),
                                        generator=gen, device=dev)
    bw = out["segmented_histogram_batched_weighted"] = b1_check(
        "segmented_histogram_batched", hs, st.samples, thetas, NCHAINS, 50)
    bw["forms"] = b1_form("weighted, 8 chains", bw["ms"], bw["device_ms"],
                          {k: bw[k] for k in ("bound_ms", "bound_by")})

    # B1a weighted: EvalHist.histogram on signal1's weighted rows.
    sig = fc.signals[0].histogram
    ev = EvalHist(sig.samples_host, sig.nfields, sig.nobservables,
                  sig.lower_host, sig.upper_host, sig.nbins,
                  dataset=sig.dataset, weights=sig.weights, device=dev)
    for d in sig.systematics:
        ev.add_systematic(d)
    ev_theta = [0.004, -0.0007]
    ev_hs = ev.hist_spec()
    got = ev.histogram(ev_theta)
    want = kernels.segmented_histogram_plain(
        ev_hs, ev.device_samples(), torch.as_tensor(ev_theta, device=dev))
    torch.cuda.synchronize()
    ties = (equal_but_ties(torch, got[0], want[0][0], "B1a weighted bins")
            + equal_but_ties(torch, got[1], want[1][0], "B1a weighted norm"))
    ms, plain_ms = in_turns(
        torch, lambda: kernels.segmented_histogram_plain(
            ev_hs, ev.device_samples(), torch.as_tensor(ev_theta,
                                                        device=dev)),
        lambda: ev.histogram(ev_theta), 5, 50)
    dms = device_ms(torch, lambda: ev.histogram(ev_theta), 50, hist_names)
    b1a = bound(sample_bytes_read(ev_hs) + f4 * (ev_hs.total + 1),
                binning_ops(ev_hs) + weight_ops(ev_hs))
    out["segmented_histogram_weighted"]["forms"].update(
        b1_form("B1a weighted, 500k, 10 bins", ms, dms, b1a))
    print(f"B1a EvalHist.histogram, weighted, {ev_hs.n} rows: {ties} bins "
          f"or norms differ (rounding ties); kernel {ms:.4f} ms (on the "
          f"card {dms} ms), plain {plain_ms:.4f} ms, bound "
          f"{b1a['bound_ms']:.4f} ms ({b1a['bound_by']})")

    # B3 weighted, one chain and 8.
    p0 = torch.as_tensor(mcmc.parameter_means, device=dev)
    gen = torch.Generator(dev).manual_seed(37)
    pc = p0 + 0.02 * torch.randn((NCHAINS, npar), generator=gen,
                                 device=dev) * torch.as_tensor(
        [1.0, 1.0, 0.1, 0.01], device=dev)
    b3_bytes = sample_bytes + f4 * (nsig * hs.total + nsig * nev)
    for name, p, nch in (("fused_nll", pc[0].contiguous(), 1),
                         ("fused_nll_batched", pc, NCHAINS)):
        fn = getattr(kernels, name)
        args = (hs, ns, st.samples, st.hist_init, rb, p)
        hi, lo = fn(*args)
        phi, plo = kernels.fused_nll_plain(*args)
        torch.cuda.synchronize()
        err = float((hi.double() + lo.double() - phi.double()
                     - plo.double()).abs().max())
        check(err <= NLL_TOL, f"{name}_weighted: NLL differs by {err}")
        ms, plain_ms = in_turns(torch, lambda: kernels.fused_nll_plain(*args),
                                lambda: fn(*args), 3, 50)
        dms = device_ms(torch, lambda: fn(*args), 50, ("sx_fused_kernel",))
        print(f"B3 {name}_weighted, {nch} chain(s): |dNLL| {err:.3g}; "
              f"kernel {ms:.4f} ms (on the card {dms} ms), plain "
              f"{plain_ms:.4f} ms")
        out[f"{name}_weighted"] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "device_ms": dms,
            **bound(b3_bytes, nch * (binning_ops(hs) + weight_ops(hs)
                                     + event_ops(nsig, nev)))}

    # B4 weighted: diagonal and tril, one chain and 8, then tempered.
    for name, nch in (("fused_segment", 1), ("fused_segment_batched",
                                             NCHAINS),
                      ("fused_segment_tril", 1),
                      ("fused_segment_tril_batched", NCHAINS)):
        params, nll0, width = initial_state(mcmc, rb, nch)
        nll0 = torch.stack(nll0, dim=-1)
        if "tril" in name:
            w = width.clamp_min(0.0)
            width = (torch.diag_embed(w) + 0.3 * torch.tril(
                torch.ones((npar, npar), device=dev), -1)
                * w[..., :, None]).contiguous()
        gen = torch.Generator(dev).manual_seed(41)
        lead = (SEGMENT_STEPS,) if nch == 1 else (SEGMENT_STEPS, nch)
        noise = torch.randn(lead + (npar,), generator=gen, device=dev)
        log_u = torch.log(torch.rand(lead, generator=gen, device=dev))
        args = (hs, ns, st.samples, st.hist_init, rb, params, nll0, width,
                noise, log_u)
        fn = getattr(kernels, name)
        got = fn(*args)
        want = kernels.fused_segment_plain(*args)
        torch.cuda.synchronize()
        err = same_walk(torch, f"{name}_weighted", got, want)
        ms, plain_ms = in_turns(
            torch, lambda: kernels.fused_segment_plain(*args),
            lambda: fn(*args), 1, 10)
        seg_bytes = (sample_bytes + f4 * (nsig * hs.total + nsig * nev)
                     + f4 * SEGMENT_STEPS * nch * (2 * npar + 4))
        print(f"B4 {name}_weighted, {nch} chain(s) x {SEGMENT_STEPS} "
              f"steps: trajectories identical (accept rate "
              f"{float(got[2].mean()):.3f}), |dNLL| {err:.3g}; kernel "
              f"{ms:.4f} ms ({ms / SEGMENT_STEPS * 1e3:.2f} us/step), plain "
              f"{plain_ms:.4f} ms")
        tril_ops = npar * (npar + 1) if "tril" in name else 0
        out[f"{name}_weighted"] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **bound(seg_bytes, SEGMENT_STEPS * nch * (
                binning_ops(hs) + weight_ops(hs) + event_ops(nsig, nev)
                + tril_ops))}
    params, nll0, width = initial_state(mcmc, rb, NTEMPS)
    out["fused_segment_tempered_weighted"] = check_tempered(
        torch, kernels, "fused_segment_tempered_weighted", hs, ns, st, rb,
        (params, torch.stack(nll0, dim=-1),
         width / torch.sqrt(beta)[:, None]), beta, noise_t, log_u_t,
        sample_bytes, nsig, nev)


def grouped_data(torch, stack, fc, nexp: int):
    """NEXP fake experiments of the fit (seeds 3, 4, ...), padded:
    their ``(nexp, nsig, nev)`` read bins and each one's event count."""
    from sxmc_tpu_torch.generator import make_fake_dataset
    from sxmc_tpu_torch.parallel.ensemble import pad_datasets

    datasets = [make_fake_dataset(torch.Generator().manual_seed(3 + e),
                                  fc.signals, fc.systematics,
                                  fc.observables, stack=stack)
                for e in range(nexp)]
    return (stack.compute_read_bins(pad_datasets(datasets)),
            [d.shape[0] for d in datasets])


def check_grouped(torch, kernels, config_path, workdir, out):
    """Phase 3, the sharded ensemble's experiment-grouped forms: each
    against its plain version and against the batched form run
    experiment by experiment, then B4-grouped against B4-batched at
    bench.py's shape."""
    from sxmc_tpu_torch.fitconfig import FitConfig
    from sxmc_tpu_torch.mcmc.metropolis import MCMC, initial_state

    dev = torch.device("cuda")
    f4 = 4.0
    nch = NEXP * CPE
    nsub = RATE_SUBSTEPS + 1
    forms = (("fused_segment_grouped", False, False),
             ("fused_segment_tril_grouped", True, False),
             ("blocked_segment_grouped", False, False),
             ("fused_segment_grouped", False, True),
             ("fused_segment_tril_grouped", True, True))
    fits = {}
    for name, tril, weighted in forms:
        if weighted not in fits:
            fc = (weighted_fit(config_path, workdir) if weighted else
                  FitConfig.from_json_file(config_path, data_root=workdir))
            mcmc = MCMC(fc.sources, fc.signals, fc.systematics,
                        fc.observables, device=dev)
            fits[weighted] = (mcmc,) + grouped_data(torch, mcmc.stack, fc,
                                                    NEXP)
        mcmc, rb, nevs = fits[weighted]
        st, ns = mcmc.stack, mcmc.nll_spec
        hs = st.hist_spec
        npar = mcmc.nparameters
        nsig, nev = rb.shape[1:]
        blocked = name.startswith("blocked")
        label = name + ("_weighted" if weighted else "")
        # Every chain starts at the means, with its experiment's NLL.
        params, _, width = initial_state(mcmc, rb[0], nch)
        nll0 = torch.stack([torch.stack(initial_state(mcmc, rb[e])[1])
                            for e in range(NEXP) for _ in range(CPE)])
        if tril:
            w = width.clamp_min(0.0)
            width = (torch.diag_embed(w) + 0.3 * torch.tril(
                torch.ones((npar, npar), device=dev), -1)
                * w[..., :, None]).contiguous()
        gen = torch.Generator(dev).manual_seed(43)
        lead = (SEGMENT_STEPS,) + ((nsub,) if blocked else ()) + (nch,)
        noise = torch.randn(lead + (npar,), generator=gen, device=dev)
        log_u = torch.log(torch.rand(lead, generator=gen, device=dev))
        args = (hs, ns, st.samples, st.hist_init, rb, params, nll0, width,
                noise, log_u)
        fn = getattr(kernels, name)
        plain = (kernels.blocked_segment_grouped_plain if blocked
                 else kernels.fused_segment_grouped_plain)
        got = fn(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        err = same_walk(torch, label, got, want)
        a = got[2]
        check(0 < float(a.sum()) < a.numel(), f"{label}: no walk")
        # Experiment by experiment through the batched form, same noise.
        batched = getattr(kernels, name.replace("grouped", "batched"))
        ax = 2 if blocked else 1
        berr = 0.0
        for e in range(NEXP):
            def part(t, dim=0):
                return t.narrow(dim, e * CPE, CPE).contiguous()

            bs, bn, ba = batched(hs, ns, st.samples, st.hist_init, rb[e],
                                 part(params), part(nll0), part(width),
                                 part(noise, ax), part(log_u, ax))
            c = slice(e * CPE, (e + 1) * CPE)
            check(torch.equal(ba, a[:, c]) and torch.equal(bs, got[0][:, c]),
                  f"{label}: experiment {e} decides otherwise than "
                  "the batched form on its read bins")
            berr = max(berr, float((bn.double().sum(-1) - got[1][:, c]
                                    .double().sum(-1)).abs().max()))
        ms, plain_ms = in_turns(torch, lambda: plain(*args),
                                lambda: fn(*args), 1, 10)
        seg_bytes = (sample_bytes_read(hs)
                     + f4 * (nsig * hs.total + NEXP * nsig * nev)
                     + f4 * nch * npar * (npar if tril else 1)
                     + f4 * SEGMENT_STEPS * nch * (
                         (nsub * (npar + 1) + npar + 3) if blocked
                         else (2 * npar + 4)))
        events = CPE * sum(event_ops(nsig, n_e) for n_e in nevs)
        ops = SEGMENT_STEPS * (
            binning_ops(hs, nch) + weight_ops(hs, nch)
            + (nsub if blocked else 1) * events
            + (nch * npar * (npar + 1) if tril else 0))
        unit = "cycle" if blocked else "step"
        print(f"{label}, {NEXP} experiments ({nevs} events, padded to "
              f"{nev}) x {CPE} chains x {SEGMENT_STEPS} {unit}s: "
              f"trajectories identical to the plain version (accept rate "
              f"{float(a.mean()):.3f}), |dNLL| {err:.3g}; experiment by "
              f"experiment through the batched form: decisions identical, "
              f"|dNLL| {berr:.3g}; kernel {ms:.4f} ms "
              f"({ms / SEGMENT_STEPS * 1e3:.2f} us/{unit}), plain "
              f"{plain_ms:.4f} ms")
        out[label] = {"max_abs_err": err, "batched_max_abs_err": berr,
                      "ms": ms, "plain_ms": plain_ms, **bound(seg_bytes, ops)}
    out["fused_segment_grouped"].update(bench_shape_turns(torch, kernels))


def bench_shape_turns(torch, kernels) -> dict:
    """B4-grouped (NEXP x CPE chains) against B4-batched (the same number
    of chains on one dataset) at bench.py's bench_sharded_ensemble shape,
    in turns (batched, grouped, grouped, batched), CUDA events and
    torch.profiler card time."""
    from sxmc_tpu_torch.mcmc.metropolis import MCMC, initial_state
    from sxmc_tpu_torch.parallel.ensemble import pad_datasets
    from sxmc_tpu_torch.signal import Observable, Signal, Source, Systematic

    dev = torch.device("cuda")
    n_mc, nevents, nch = 1_000_000, 3000, NEXP * CPE
    rng = np.random.default_rng(5)
    obs = Observable(name="energy", field="energy", bins=100, lower=5.0,
                     upper=15.0, field_index=0)
    syst = Systematic(name="shift", type=0, observable_field="energy",
                      means=[0.0], sigmas=[0.05], observable_field_index=0,
                      pidx=[0])
    fields = ["energy", "DATASET"]
    src_s = Source(name="sig", index=0, mean=1.0)
    src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
    sig = Signal.from_table("sig", "s", rng.normal(10, 1, (n_mc, 1)).astype(
        np.float32), ["energy"], 0, src_s, 1000.0, fields, [obs], [], [syst])
    bkg = Signal.from_table("bkg", "b", rng.uniform(5, 15, (n_mc, 1)).astype(
        np.float32), ["energy"], 0, src_b, 2000.0, fields, [obs], [], [])
    mcmc = MCMC([src_s, src_b], [sig, bkg], [syst], [obs], device=dev)
    st, ns = mcmc.stack, mcmc.nll_spec
    datasets = [np.stack([rng.uniform(5, 15, nevents - 7 * e).astype(
        np.float32), np.zeros(nevents - 7 * e, np.float32)], axis=1)
        for e in range(NEXP)]
    rb = st.compute_read_bins(pad_datasets(datasets))
    params, nll0, width = initial_state(mcmc, rb[0], nch)
    nll0 = torch.stack(nll0, dim=-1)
    gen = torch.Generator(dev).manual_seed(47)
    noise = torch.randn((SEGMENT_STEPS, nch, mcmc.nparameters),
                        generator=gen, device=dev)
    log_u = torch.log(torch.rand((SEGMENT_STEPS, nch), generator=gen,
                                 device=dev))
    rest = (params, nll0, width, noise, log_u)
    base = (st.hist_spec, ns, st.samples, st.hist_init)
    rb0 = rb[0, :, :nevents].contiguous()  # experiment 0, unpadded

    def grouped():
        return kernels.fused_segment_grouped(*base, rb, *rest)

    def batched():
        return kernels.fused_segment_batched(*base, rb0, *rest)

    g_ms, b_ms = in_turns(torch, batched, grouped, 10, 10)
    # Card time in turns too (batched, grouped, grouped, batched).
    names = ("sx_fused_kernel",)
    b1, g1, g2, b2 = (device_ms(torch, fn, 10, names)
                      for fn in (batched, grouped, grouped, batched))
    print(f"card time a {SEGMENT_STEPS}-step segment in turns (batched, "
          f"grouped, grouped, batched): {b1}, {g1}, {g2}, {b2} ms")
    g_dev = (g1 + g2) / 2 if g1 and g2 else None
    b_dev = (b1 + b2) / 2 if b1 and b2 else None
    # A 40-ms launch's card time is its CUDA-event time to well within
    # 5% (one launch gap); a card time further off is not trusted and
    # stays out of the kernels line.
    for what, dev_ms, ev_ms in (("grouped", g_dev, g_ms),
                                ("batched", b_dev, b_ms)):
        agree = dev_ms is not None and abs(dev_ms / ev_ms - 1) <= 0.05
        print(f"{what}: card time {dev_ms} ms against CUDA events "
              f"{ev_ms:.4f} ms a segment: "
              f"{'agree' if agree else 'DISAGREE, left out'}")
        if not agree:
            if what == "grouped":
                g_dev = None
            else:
                b_dev = None
    hs, npar, f4 = st.hist_spec, mcmc.nparameters, 4.0
    nsig = rb.shape[1]
    nevs = [d.shape[0] for d in datasets]
    bnd = bound(sample_bytes_read(hs) + f4 * (nsig * hs.total + rb.numel())
                + f4 * SEGMENT_STEPS * nch * (2 * npar + 4),
                SEGMENT_STEPS * (binning_ops(hs, nch) + CPE * sum(
                    event_ops(nsig, n_e) for n_e in nevs)))
    print(f"bench_sharded_ensemble shape (2 x {n_mc} MC, 100 bins, shift; "
          f"{[d.shape[0] for d in datasets]} events): B4-grouped {NEXP} x "
          f"{CPE} chains {g_ms / SEGMENT_STEPS * 1e3:.2f} us/step (on the "
          f"card {g_dev} ms a segment), B4-batched {nch} chains on one "
          f"dataset {b_ms / SEGMENT_STEPS * 1e3:.2f} us/step (on the card "
          f"{b_dev} ms); {nch * SEGMENT_STEPS / g_ms * 1e3:.6g} against "
          f"{nch * SEGMENT_STEPS / b_ms * 1e3:.6g} chain-steps/s in the "
          f"kernel; grouped bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    return {"bench_shape_ms": g_ms, "bench_shape_device_ms": g_dev,
            "bench_shape_batched_ms": b_ms,
            "bench_shape_batched_device_ms": b_dev,
            "bench_shape_bound_ms": bnd["bound_ms"]}


# Per path: the fit's edits, the CLI flags, its step count, and the exact
# launches of every kernel per experiment (nsteps + 1 for B1-batched on
# the binned path: the initial NLL, then every step).
PATHS = [
    ("default", {}, [], FULL_STEPS,
     {"segmented_histogram": 1, "fused_nll": 1, "fused_segment": 3}),
    ("nchains=8", {"nchains": NCHAINS}, [], FULL_STEPS,
     {"segmented_histogram": 1, "fused_nll_batched": 1,
      "fused_segment_batched": 3}),
    ("fixed systematics", {"fixed": True}, [], LOOP_STEPS,
     {"segmented_histogram": 2, "lut_eval": 1}),
    ("binned, nchains=8", {"nchains": NCHAINS}, ["--binned"], LOOP_STEPS,
     {"segmented_histogram": 1,
      "segmented_histogram_batched": LOOP_STEPS + 1}),
    ("full_cov", {"proposal": "full_cov"}, [], FULL_STEPS,
     {"segmented_histogram": 1, "fused_nll": 1, "fused_segment_tril": 3}),
    ("full_cov, nchains=8", {"proposal": "full_cov", "nchains": NCHAINS},
     [], FULL_STEPS,
     {"segmented_histogram": 1, "fused_nll_batched": 1,
      "fused_segment_tril_batched": 3}),
    ("rate_substeps=4", {"rate_substeps": RATE_SUBSTEPS}, [], FULL_STEPS,
     {"segmented_histogram": 1, "fused_nll": 1, "blocked_segment": 3}),
    ("rate_substeps=4, nchains=8",
     {"rate_substeps": RATE_SUBSTEPS, "nchains": NCHAINS}, [], FULL_STEPS,
     {"segmented_histogram": 1, "fused_nll_batched": 1,
      "blocked_segment_batched": 3}),
    # Binned blocked stepper: B1 for the fake data, the initial NLL, the
    # carried histograms at the start, then once per cycle.
    ("rate_substeps=4, binned", {"rate_substeps": RATE_SUBSTEPS},
     ["--binned"], SHORT_STEPS, {"segmented_histogram": SHORT_STEPS + 3}),
    ("full_cov, fixed systematics", {"proposal": "full_cov", "fixed": True},
     [], SHORT_STEPS, {"segmented_histogram": 2, "lut_eval": 1}),
]


def tempered_launches(nsteps: int) -> int:
    """B4-tempered launches of a tempered fit: per phase one per full
    swap interval and one for the remainder."""
    nburn = int(nsteps * 0.2)
    return sum(n // SWAP_EVERY + (n % SWAP_EVERY > 0)
               for n in (nburn, nburn, nsteps - 2 * nburn) if n)


# The paths of the tempered sampler and of weighted MC.  Tempered: B1
# for the fake data, the initial ladder NLL through B1-batched + B2 (the
# JAX package's _chain_nll_batch without allow_fused), then one B4-
# tempered launch per swap interval; with fixed systematics the stepper
# (B1 + B2 once).  Weighted: run through run_ensemble (the config has no
# weights key), every kernel in its weighted form.
TEMPERED = {"sampler": "tempered"}
WEIGHTED = {"weighted": True}
PATHS += [
    ("tempered", TEMPERED, ["--sampler", "tempered"], FULL_STEPS,
     {"segmented_histogram": 1, "segmented_histogram_batched": 1,
      "lut_eval": 1, "fused_segment_tempered": tempered_launches(
          FULL_STEPS)}),
    ("tempered, fixed systematics", dict(TEMPERED, fixed=True),
     ["--sampler", "tempered"], SHORT_STEPS,
     {"segmented_histogram": 2, "lut_eval": 1}),
    ("weighted", WEIGHTED, [], FULL_STEPS,
     {"segmented_histogram_weighted": 1, "fused_nll_weighted": 1,
      "fused_segment_weighted": 3}),
    ("weighted, nchains=8", dict(WEIGHTED, nchains=NCHAINS), [], FULL_STEPS,
     {"segmented_histogram_weighted": 1, "fused_nll_batched_weighted": 1,
      "fused_segment_batched_weighted": 3}),
    ("weighted, full_cov", dict(WEIGHTED, proposal="full_cov"), [],
     FULL_STEPS,
     {"segmented_histogram_weighted": 1, "fused_nll_weighted": 1,
      "fused_segment_tril_weighted": 3}),
    ("weighted, full_cov, nchains=8",
     dict(WEIGHTED, proposal="full_cov", nchains=NCHAINS), [], FULL_STEPS,
     {"segmented_histogram_weighted": 1, "fused_nll_batched_weighted": 1,
      "fused_segment_tril_batched_weighted": 3}),
    ("weighted, tempered", dict(WEIGHTED, **TEMPERED), [], FULL_STEPS,
     {"segmented_histogram_weighted": 1,
      "segmented_histogram_batched_weighted": 1, "lut_eval": 1,
      "fused_segment_tempered_weighted": tempered_launches(FULL_STEPS)}),
]


def path_config(config_path: str, workdir: str, tag: str, edits: dict,
                nsteps: int) -> str:
    with open(config_path) as f:
        cfg = json.load(f)
    cfg["fit"]["nsteps"] = nsteps
    for key in ("nexperiments", "nchains", "proposal", "rate_substeps"):
        if edits.get(key):
            cfg["fit"][key] = edits[key]
    if edits.get("fixed"):
        for syst in cfg["pdfs"]["systematics"].values():
            syst["fixed"] = True
    path = os.path.join(workdir, tag.replace(" ", "_").replace(",", "")
                        .replace("=", "") + ".json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


def main_paths(torch, kernels, config_path: str, workdir: str):
    """Phase 4: the paths through the CLI (weighted ones through
    run_ensemble), counters around each."""
    from sxmc_tpu_torch.cli import main as cli_main
    from sxmc_tpu_torch.ensemble import run_ensemble
    from sxmc_tpu_torch.stats.likelihood import LikelihoodSpace

    dev = torch.device("cuda")
    results = []
    for tag, edits, flags, nsteps, expect in PATHS:
        if nsteps != FULL_STEPS:
            print(f"{tag}: cut to {nsteps} steps (the example has "
                  f"{FULL_STEPS}): the stepper loop is host-bound")
        m = edits.get("rate_substeps", 0)
        sampler = edits.get("sampler", "metropolis")
        cfg = path_config(config_path, workdir, tag, edits, nsteps)
        out = os.path.join(workdir, "out_" + os.path.basename(cfg)[:-5])
        fc = weighted_fit(cfg, workdir) if edits.get("weighted") else None
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        if fc is None:
            rc = cli_main([cfg, out, "--data-root", workdir, "--device",
                           "cuda", "--max-retries", "0"] + flags)
        else:
            limits = run_ensemble(fc, out, device=dev, sampler=sampler,
                                  max_retries=0, verbose=False)
            rc = 0 if len(limits) == 1 else 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        check(rc == 0, f"{tag}: cli returned {rc}")
        want = {k: expect.get(k, 0) for k in counts}
        check(counts == want, f"{tag}: launches {counts}, expected {want}")
        with open(os.path.join(out, "example_metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        failed = [r for r in recs if r["event"] == "experiment_failed"]
        check(not failed, f"{tag}: an experiment failed: {failed}")
        limits = [r["upper"] for r in recs
                  if r["event"] == "experiment_limit"]
        check(len(limits) == 1 and all(math.isfinite(x) for x in limits),
              f"{tag}: limits {limits}")
        fit = next(r for r in recs if r["event"] == "experiment_fit")
        result = next(r for r in recs if r["event"] == "experiment_result")
        check(0.02 < fit["accept_rate"] < 0.95,
              f"{tag}: acceptance rate {fit['accept_rate']}")
        best = result["best_fit"]
        check(all(math.isfinite(v) for v in best.values()),
              f"{tag}: best fit {best}")
        # The fake data is drawn at the nominal rates: the fitted signal1
        # rate sits near 1 (about 1000 expected events, ~5% statistical).
        check(0.7 < best["signal1"] < 1.3,
              f"{tag}: best-fit signal1 {best['signal1']}")
        # The tempered sampler returns its cold chain alone.
        nch = edits.get("nchains", 1) if sampler == "metropolis" else 1
        nkeep = nsteps - 2 * int(nsteps * 0.2)
        ls = LikelihoodSpace.load(os.path.join(out, "example_0.npz"))
        check(ls.samples.shape == (nch * nkeep, 4)
              and np.isfinite(ls.samples).all()
              and np.isfinite(ls.nll_values).all(),
              f"{tag}: likelihood space {ls.samples.shape}")
        if edits.get("fixed"):
            check(bool((ls.samples[:, 2:] == 0.0).all()),
                  f"{tag}: a fixed systematic moved")
        # bench.py's mcmc_updates_per_sec_blocked: every decision of a
        # blocked cycle updates a block of parameters.
        updates = fit["steps_per_sec"] * (m + 1) if m else None
        # A ladder step advances every replica.
        replica = (fit["steps_per_sec"] * NTEMPS if sampler == "tempered"
                   else None)
        print(f"path {tag}: limit {limits[0]:.6g}, best fit {best}, accept "
              f"rate {fit['accept_rate']:.4f}, {nsteps} "
              f"{'cycles' if m else 'steps'} x {nch} chain(s) in "
              f"{fit['wall_seconds']:.3f} s = {fit['steps_per_sec']!r} "
              f"chain-{'cycles' if m else 'steps'}/s"
              + (f" ({updates!r} parameter updates/s)" if m else "")
              + (f" ({replica!r} replica-steps/s)" if replica else "")
              + f", whole run {wall:.2f} s; launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        results.append({"path": tag, "nsteps": nsteps, "nchains": nch,
                        "steps_per_sec": fit["steps_per_sec"],
                        "updates_per_sec": updates,
                        "replica_steps_per_sec": replica,
                        "wall_seconds": fit["wall_seconds"],
                        "cli_seconds": wall, "limit": limits[0],
                        "accept_rate": fit["accept_rate"],
                        "launches": counts})
    return results


# The sharded ensemble's paths: NEXP fake experiments x CPE chains as
# one batch.  Per path: the edits, the CLI flags (None: through
# run_sharded_ensemble, the signals weighted), the step count and the
# exact launches: B1 for each experiment's fake data, B3 for each
# experiment's initial NLL, then one grouped launch per phase; --binned
# runs experiment by experiment on the stepper (B1-batched for the
# initial NLL of each experiment's chains, then once a step).
SHARDED = {"nexperiments": NEXP, "nchains": CPE}
SHARDED_PATHS = [
    ("sharded", {}, [], FULL_STEPS,
     {"segmented_histogram": NEXP, "fused_nll": NEXP,
      "fused_segment_grouped": 3}),
    ("sharded, full_cov", {"proposal": "full_cov"}, [], FULL_STEPS,
     {"segmented_histogram": NEXP, "fused_nll": NEXP,
      "fused_segment_tril_grouped": 3}),
    ("sharded, rate_substeps=4", {"rate_substeps": RATE_SUBSTEPS}, [],
     FULL_STEPS, {"segmented_histogram": NEXP, "fused_nll": NEXP,
                  "blocked_segment_grouped": 3}),
    ("sharded, binned", {}, ["--binned"], SHORT_STEPS,
     {"segmented_histogram": NEXP,
      "segmented_histogram_batched": NEXP * (SHORT_STEPS + 1)}),
    ("sharded, weighted", {"weighted": True}, None, FULL_STEPS,
     {"segmented_histogram_weighted": NEXP, "fused_nll_weighted": NEXP,
      "fused_segment_grouped_weighted": 3}),
    ("sharded, weighted, full_cov", {"weighted": True,
                                     "proposal": "full_cov"}, None,
     FULL_STEPS,
     {"segmented_histogram_weighted": NEXP, "fused_nll_weighted": NEXP,
      "fused_segment_tril_grouped_weighted": 3}),
]


def sharded_paths(torch, kernels, config_path: str, workdir: str):
    """Phase 4, the sharded ensemble: through the CLI's --sharded (the
    weighted paths through run_sharded_ensemble), counters around each;
    chain-steps/s = nsteps x nexp x nchains / the fit's wall (host clock,
    ending in a device synchronisation), the fake-data set-up timed on
    its own."""
    from sxmc_tpu_torch.cli import main as cli_main
    from sxmc_tpu_torch.observability import MetricsLogger
    from sxmc_tpu_torch.parallel.ensemble import run_sharded_ensemble

    dev = torch.device("cuda")
    results = []
    for tag, edits, flags, nsteps, expect in SHARDED_PATHS:
        if nsteps != FULL_STEPS:
            print(f"{tag}: cut to {nsteps} steps (the example has "
                  f"{FULL_STEPS}): the stepper loop is host-bound")
        m = edits.get("rate_substeps", 0)
        cfg = path_config(config_path, workdir, tag, dict(SHARDED, **edits),
                          nsteps)
        out = os.path.join(workdir, "out_" + os.path.basename(cfg)[:-5])
        fc = None
        if flags is None:
            fc = weighted_fit(cfg, workdir)
            os.makedirs(out, exist_ok=True)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        if fc is None:
            rc = cli_main([cfg, out, "--data-root", workdir, "--device",
                           "cuda", "--sharded"] + flags)
        else:
            run_sharded_ensemble(fc, device=dev, verbose=False,
                                 metrics=MetricsLogger(os.path.join(
                                     out, "example_metrics.jsonl")))
            rc = 0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        check(rc == 0, f"{tag}: cli returned {rc}")
        want = {k: expect.get(k, 0) for k in counts}
        check(counts == want, f"{tag}: launches {counts}, expected {want}")
        with open(os.path.join(out, "example_metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        setup = next(r for r in recs if r["event"] == "sharded_setup")
        fit = next(r for r in recs if r["event"] == "sharded_fit")
        limits = [r["upper"] for r in recs
                  if r["event"] == "experiment_limit"]
        check(len(limits) == NEXP and all(math.isfinite(x) for x in limits),
              f"{tag}: limits {limits}")
        # Each experiment's fake data is drawn at the nominal rates: the
        # limit on signal1 sits a little above 1.
        check(all(0.8 < x < 1.5 for x in limits), f"{tag}: limits {limits}")
        if fc is None:
            from sxmc_tpu_torch.stats.likelihood import LikelihoodSpace

            nkeep = nsteps - 2 * int(nsteps * 0.2)
            for i in range(NEXP):
                ls = LikelihoodSpace.load(os.path.join(out,
                                                       f"example_{i}.npz"))
                check(ls.samples.shape == (CPE * nkeep, 4)
                      and np.isfinite(ls.samples).all()
                      and np.isfinite(ls.nll_values).all(),
                      f"{tag}: experiment {i}'s likelihood space "
                      f"{ls.samples.shape}")
        rate = fit["steps_per_sec"]
        updates = rate * (m + 1) if m else None
        print(f"path {tag}: route {fit['route']}, limits "
              f"{[round(x, 6) for x in limits]}, {nsteps} "
              f"{'cycles' if m else 'steps'} x {NEXP} experiments x {CPE} "
              f"chains in {fit['wall_seconds']:.3f} s = {rate!r} chain-"
              f"{'cycles' if m else 'steps'}/s"
              + (f" ({updates!r} parameter updates/s)" if m else "")
              + f"; fake data and read bins {setup['seconds']:.3f} s "
              f"({setup['nevents']} events a padded experiment); whole run "
              f"{wall:.2f} s; launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        results.append({"path": tag, "nsteps": nsteps,
                        "nchains": NEXP * CPE, "steps_per_sec": rate,
                        "updates_per_sec": updates,
                        "replica_steps_per_sec": None,
                        "wall_seconds": fit["wall_seconds"],
                        "setup_seconds": setup["seconds"],
                        "cli_seconds": wall, "limits": limits,
                        "launches": counts})
    return results


# The frequentist tier's paths: the example at its full width, one
# experiment, 200 toys (the JAX defaults; --gof 100).  Their launches
# follow from the code (stats/mle.py, stats/hypotest.py, stats/gof.py,
# stats/bias.py, stats/feldman_cousins.py):
#   a fit: the systematics grid, 4 passes x 2 floating systematics, each
#     one evaluate_batch of 9 thetas (B1-batched + B2; binned B1-batched
#     alone), then the rate solve and the Hessian at the optimum (B1 + B2
#     each; binned B1 each);
#   a profile or a conditional fit: B1 + B2 at the fit's systematics;
#   a toy ensemble: B1 to draw it, then B1 + B2 for every toy's LUT (one
#     launch over all toys' events), B1 + B2 more for the conditional fit
#     that sets the background rates of a hypothesis-test ensemble;
#   the fake dataset: B1.
NTOYS = 200
GOF_TOYS = 100
FC_GRID = 8
NGRID = 8              # the CLs grid's points before refinement
FIT = {"segmented_histogram": 2, "segmented_histogram_batched": 8,
       "lut_eval": 10}
FIT_BINNED = {"segmented_histogram": 2, "segmented_histogram_batched": 8}
B12 = {"segmented_histogram": 1, "lut_eval": 1}
B1 = {"segmented_histogram": 1}


def launches(*parts) -> dict:
    """The sum of launch counts ``(count, {kernel: n})`` or dicts."""
    out = {}
    for part in parts:
        n, d = part if isinstance(part, tuple) else (1, part)
        for k, v in d.items():
            out[k] = out.get(k, 0) + n * v
    return out


def hypotest_launches(ngrid: int, refined: bool) -> dict:
    """The hypothesis-test path (--hypotest 200 --hypotest-band
    --hypotest-asymptotic) beside the Metropolis fit: discovery (a fit, the
    profile at 0, one b-only toy ensemble), the fit and profile limit that
    set the grid, the CLs scan (a fit, the observed profile, two ensembles
    a grid point, a second observed profile over the refinement points
    when the scan brackets its crossing), the band (two ensembles a
    point), the Asimov limit (a fit, a profile, a conditional fit, the
    Asimov histograms, a weighted fit, its profile); then the Metropolis
    fit (B3 once, B4 per phase) on the fake dataset (B1)."""
    ensemble = launches(B1, (2, B12))  # draw, conditional fit, toys' LUT
    return launches(
        B1, FIT, B12, ensemble,                      # discovery
        FIT, B12,                                    # grid from the limit
        FIT, B12, (2 * ngrid, ensemble), (int(refined), B12),  # CLs
        (2 * ngrid, ensemble),                       # band
        FIT, B12, B12, B1, FIT, B12,                 # Asimov
        {"fused_nll": 1, "fused_segment": 3})


STATS_PATHS = [
    # (tag, CLI flags, exact launches or None: from the hypotest JSON)
    ("mle, gof 100", ["--sampler", "mle", "--gof", str(GOF_TOYS)],
     launches(B1, FIT, B1, B1, B12, B1, (2, B12))),
    ("mle, binned", ["--sampler", "mle", "--binned"],
     launches(B1, FIT_BINNED, (2, B1))),
    ("hypotest 200, band, asymptotic",
     ["--hypotest", str(NTOYS), "--hypotest-band", "--hypotest-asymptotic"],
     None),
    ("mle, bias-study 200", ["--sampler", "mle", "--bias-study", str(NTOYS)],
     launches(B1, B12, B1, FIT, (2, B12))),
]


def stats_paths(torch, kernels, config_path: str, workdir: str):
    """Phase 4, the frequentist tier through the CLI: each path's launches
    exact, its JSON outputs written and finite, no failed experiment; the
    wall, the toy datasets and toy fits per second (host clock, ending
    in a synchronisation) and the batched solver's ticks and host reads
    beside them."""
    from sxmc_tpu_torch.cli import main as cli_main
    from sxmc_tpu_torch.stats import bfgs

    results = []
    for tag, flags, expect in STATS_PATHS:
        cfg = path_config(config_path, workdir, tag, {}, FULL_STEPS)
        out = os.path.join(workdir, "out_" + os.path.basename(cfg)[:-5])
        kernels.reset_launch_counts()
        bfgs.reset_solver_stats()
        t0 = time.perf_counter()
        rc = cli_main([cfg, out, "--data-root", workdir, "--device", "cuda",
                       "--max-retries", "0"] + flags)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        solver = bfgs.solver_stats()
        check(rc == 0, f"{tag}: cli returned {rc}")
        with open(os.path.join(out, "example_metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        failed = [r for r in recs if r["event"] == "experiment_failed"]
        check(not failed, f"{tag}: an experiment failed: {failed}")
        toys = fits = 0
        if "--hypotest" in flags:
            with open(os.path.join(out, "example_hypotest_0.json")) as f:
                ht = json.load(f)
            ngrid = len(ht["r_grid"])
            check(ngrid in (NGRID, NGRID + 4), f"{tag}: grid {ngrid}")
            expect = hypotest_launches(ngrid, ngrid > NGRID)
            for key in ("cls_limit", "profile_limit", "asymptotic_limit",
                        "q0", "z_toys"):
                check(math.isfinite(ht[key]), f"{tag}: {key} {ht[key]}")
            band = list(ht["expected_limit"].values()) + list(
                ht["asymptotic_expected"].values())
            check(all(math.isfinite(x) for x in band), f"{tag}: bands {band}")
            limit = next(r["upper"] for r in recs
                         if r["event"] == "experiment_limit")
            ensembles = 1 + 4 * ngrid
            toys, fits = NTOYS * ensembles, 2 * NTOYS * ensembles
            extra = (f"CLs limit {ht['cls_limit']:.6g}, expected (median) "
                     f"{ht['expected_limit']['0.5']:.6g}, Asimov "
                     f"{ht['asymptotic_limit']:.6g}, q0 {ht['q0']:.4g}, "
                     f"grid {ngrid} points, Metropolis limit {limit:.6g}")
        else:
            with open(os.path.join(out, "example_mle_0.json")) as f:
                res = json.load(f)
            limit = res["upper_limit"]
            check(res["converged"], f"{tag}: the fit did not converge")
            check(math.isfinite(limit) and 0.7 < res["params"]["signal1"]
                  < 1.3, f"{tag}: limit {limit}, fit {res['params']}")
            extra = (f"profile limit {limit:.6g}, signal1 "
                     f"{res['params']['signal1']:.6g} +- "
                     f"{res['errors']['signal1']:.4g}, NLL {res['nll']!r}")
            if "--gof" in flags:
                gof = next(r for r in recs if r["event"] == "experiment_gof")
                check(math.isfinite(gof["chi2"])
                      and 0.0 <= gof["p_toys"] <= 1.0, f"{tag}: gof {gof}")
                toys = fits = GOF_TOYS
                extra += (f", chi2/ndof {gof['chi2']:.4g}/{gof['ndof']}, "
                          f"p {gof['p_asymptotic']:.4g} (toys "
                          f"{gof['p_toys']:.4g})")
            if "--bias-study" in flags:
                with open(os.path.join(out, "example_pulls.json")) as f:
                    pulls = json.load(f)["summary"]
                s1 = pulls["signal1"]
                # signal1's Gaussian constraint (sigma 0.05) narrows its
                # pulls below 1: their width is only held finite here.
                check(s1["n_used"] > 0.9 * NTOYS
                      and abs(s1["pull_mean"]) < 0.5
                      and 0.05 < s1["pull_std"] < 1.5, f"{tag}: pulls {s1}")
                toys = fits = NTOYS
                extra += (f", signal1 pull mean {s1['pull_mean']:.4f} width "
                          f"{s1['pull_std']:.4f} coverage {s1['coverage']}")
        want = {k: expect.get(k, 0) for k in counts}
        check(counts == want, f"{tag}: launches {counts}, expected {want}")
        rate = (f", {toys / wall!r} toy datasets/s, {fits / wall!r} toy "
                f"fits/s" if toys else "")
        print(f"path {tag}: {extra}; whole run {wall:.2f} s{rate}; solver "
              f"{solver['solves']} batched solves, {solver['ticks']} ticks, "
              f"{solver['syncs']} host reads; launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        results.append({"path": tag, "cli_seconds": wall, "limit": limit,
                        "toys": toys, "toy_fits": fits, "solver": solver,
                        "launches": counts})
    return results


def fc_path(torch, kernels, config_path: str, workdir: str) -> dict:
    """FeldmanCousins.run through the library: FC_GRID grid points x NTOYS
    toys of the example around its fake dataset (drawn first, outside the
    counted run).  Launches: a B1 draw per grid point, B1 + B2 for the
    toys' LUT, then the observed fit and profile."""
    from sxmc_tpu_torch.fitconfig import FitConfig
    from sxmc_tpu_torch.generator import make_fake_dataset
    from sxmc_tpu_torch.stats import bfgs
    from sxmc_tpu_torch.stats.feldman_cousins import FeldmanCousins
    from sxmc_tpu_torch.stats.mle import MLE

    dev = torch.device("cuda")
    fc = FitConfig.from_json_file(config_path, data_root=workdir)
    mle = MLE(fc.sources, fc.signals, fc.systematics, fc.observables,
              device=dev)
    data = make_fake_dataset(torch.Generator().manual_seed(3), fc.signals,
                             fc.systematics, fc.observables, stack=mle.stack)
    grid = np.linspace(0.85, 1.15, FC_GRID)  # ~1.5 sigma a step
    kernels.reset_launch_counts()
    bfgs.reset_solver_stats()
    t0 = time.perf_counter()
    iv = FeldmanCousins(mle, "signal1").run(
        torch.Generator(dev).manual_seed(7), data, grid, ntoys=NTOYS, cl=0.9)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    solver = bfgs.solver_stats()
    expect = launches((FC_GRID, B1), B12, FIT, B12)
    want = {k: expect.get(k, 0) for k in counts}
    check(counts == want, f"FC: launches {counts}, expected {want}")
    check(math.isfinite(iv.lower) and math.isfinite(iv.upper)
          and iv.lower < iv.point_estimate < iv.upper, f"FC: interval {iv}")
    toys = FC_GRID * NTOYS
    print(f"path FeldmanCousins.run: interval [{iv.lower:.6g}, "
          f"{iv.upper:.6g}] around {iv.point_estimate:.6g} (90% CL), "
          f"{FC_GRID} grid points x {NTOYS} toys in {wall:.3f} s = "
          f"{toys / wall!r} toy datasets/s, {2 * toys / wall!r} toy fits/s; "
          f"solver {solver['solves']} batched solves, {solver['ticks']} "
          f"ticks, {solver['syncs']} host reads; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    return {"path": "FeldmanCousins.run", "cli_seconds": wall,
            "limit": iv.upper, "toys": toys, "toy_fits": 2 * toys,
            "solver": solver, "launches": counts}


def check_mle_cpu(torch, kernels, config_path: str, workdir: str) -> dict:
    """The MLE with the kernels against device="cpu" (the plain versions)
    on the same data: best-fit NLL within NLL_TOL, every free rate, the
    profile limit and the Asimov limit within 1e-3 relative; then
    toy_dnll_batch on 64 fixed toys with its B2 launch against
    lut_eval_plain on the card (dNLL within 2e-3, r-hat 1e-3 relative)."""
    from sxmc_tpu_torch.fitconfig import FitConfig
    from sxmc_tpu_torch.generator import (make_fake_dataset,
                                          make_fake_dataset_batch)
    from sxmc_tpu_torch.stats.feldman_cousins import toy_dnll_batch
    from sxmc_tpu_torch.stats.hypotest import HypoTest
    from sxmc_tpu_torch.stats.mle import MLE

    fc = FitConfig.from_json_file(config_path, data_root=workdir)
    out = {}
    models = {}
    t0 = time.perf_counter()
    for name in ("cuda", "cpu"):
        mle = MLE(fc.sources, fc.signals, fc.systematics, fc.observables,
                  device=torch.device(name))
        models[name] = mle
    data = make_fake_dataset(torch.Generator().manual_seed(3), fc.signals,
                             fc.systematics, fc.observables,
                             stack=models["cuda"].stack)
    for name, mle in models.items():
        res = mle.fit(data)
        lim = mle.upper_limit("signal1", 0.9, res)
        out[name] = (res, lim)
    (rg, lg), (rc, lc) = out["cuda"], out["cpu"]
    hi = max(2.0 * lc, 1e-2)
    grid = np.linspace(hi / 8.0, hi, 8)
    asym = {name: HypoTest(mle, "signal1").asymptotic_upper_limit(
        data, grid, cl=0.9).limit for name, mle in models.items()}
    dn = float(abs(rg.nll - rc.nll))
    check(dn <= NLL_TOL, f"MLE card vs CPU: NLL {rg.nll!r} vs {rc.nll!r}")
    rel = {}
    for i in models["cuda"]._free_rates:
        n = rg.names[i]
        rel[n] = float(abs(rg.params[i] - rc.params[i]) / abs(rc.params[i]))
    rel["profile_limit"] = float(abs(lg - lc) / abs(lc))
    rel["asimov_limit"] = float(abs(asym["cuda"] - asym["cpu"])
                                / abs(asym["cpu"]))
    check(max(rel.values()) <= 1e-3, f"MLE card vs CPU: relative {rel}")
    check(rg.converged and rc.converged, "MLE card vs CPU: not converged")

    mle = models["cuda"]
    dev = mle.device
    toys = make_fake_dataset_batch(torch.Generator(dev).manual_seed(11),
                                   mle.signals, mle.systematics,
                                   mle.observables, 64, mle.stack)
    rb = mle.stack.compute_read_bins(toys)
    r_values = np.linspace(0.5, 1.5, 64)
    got = toy_dnll_batch(mle, r_values, rb, 0, mle._free_rates)
    kernel = kernels.lut_eval
    kernels.lut_eval = kernels.lut_eval_plain
    try:
        want = toy_dnll_batch(mle, r_values, rb, 0, mle._free_rates)
    finally:
        kernels.lut_eval = kernel
    d_err = float(np.abs(got[0] - want[0]).max())
    r_err = float((np.abs(got[1] - want[1]) / np.abs(want[1])).max())
    check(d_err <= 2e-3 and r_err <= 1e-3,
          f"toy_dnll_batch with B2 vs lut_eval_plain: dNLL {d_err}, "
          f"r-hat {r_err}")
    wall = time.perf_counter() - t0
    print(f"MLE card vs CPU on the example: NLL {rg.nll!r} vs {rc.nll!r} "
          f"(|d| {dn:.3g}), relative differences "
          f"{ {k: float(f'{v:.3g}') for k, v in rel.items()} }, profile "
          f"limit {lg:.6g}, Asimov limit {asym['cuda']:.6g}; toy_dnll_batch "
          f"on 64 toys, B2 vs lut_eval_plain: max |d dNLL| {d_err:.3g}, max "
          f"relative d r-hat {r_err:.3g} ({wall:.1f} s)")
    return {"nll_abs": dn, "relative": rel, "toy_dnll_abs": d_err,
            "toy_rhat_rel": r_err}


def tempered_split(torch, config_path: str, workdir: str) -> dict:
    """The tempered fit's wall against its device time: the example at
    its full width through TemperedMCMC (SPLIT_STEPS steps), once on the
    host clock alone and once under torch.profiler (kernel times only)."""
    from torch.profiler import ProfilerActivity, profile

    from sxmc_tpu_torch.fitconfig import FitConfig
    from sxmc_tpu_torch.generator import make_fake_dataset
    from sxmc_tpu_torch.mcmc.tempered import TemperedMCMC

    dev = torch.device("cuda")
    fc = FitConfig.from_json_file(config_path, data_root=workdir)
    tmc = TemperedMCMC(fc.sources, fc.signals, fc.systematics,
                       fc.observables, ntemps=NTEMPS, tmax=TMAX,
                       swap_every=SWAP_EVERY, device=dev)
    data = make_fake_dataset(torch.Generator().manual_seed(3), fc.signals,
                             fc.systematics, fc.observables, stack=tmc.stack)

    def fit():
        tmc(data, SPLIT_STEPS, 0.2,
            generator=torch.Generator(dev).manual_seed(5))
        torch.cuda.synchronize()

    fit()  # warm
    t0 = time.perf_counter()
    fit()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fit()
    kern = other = 0.0
    for ev in prof.key_averages():
        us = (getattr(ev, "device_time_total", None)
              or getattr(ev, "cuda_time_total", 0.0))
        if "sx_fused_kernel" in ev.key:
            kern += us / 1e6
        else:
            other += us / 1e6
    intervals = tempered_launches(SPLIT_STEPS)
    print(f"tempered fit, {SPLIT_STEPS} steps x {NTEMPS} replicas "
          f"({intervals} B4-tempered launches): wall {wall:.3f} s, "
          f"B4-tempered on the card {kern:.3f} s "
          f"({kern / intervals * 1e3:.4f} ms a swap interval), other "
          f"kernels (exchange, copies) {other:.3f} s, the card idle "
          f"{max(wall - kern - other, 0.0):.3f} s "
          f"({max(wall - kern - other, 0.0) / wall:.2%} of the wall)")
    return {"wall_s": wall, "kernel_s": kern, "other_device_s": other,
            "intervals": intervals}


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
        paths = main_paths(torch, kernels, config_path, workdir)
        paths += sharded_paths(torch, kernels, config_path, workdir)
        stats = stats_paths(torch, kernels, config_path, workdir)
        stats.append(fc_path(torch, kernels, config_path, workdir))
        mle_check = check_mle_cpu(torch, kernels, config_path, workdir)
        split = tempered_split(torch, config_path, workdir)
    paths += stats

    rows = []
    for name, replaces in REPLACES.items():
        launches = sum(p["launches"][name] for p in paths)
        check(launches > 0, f"{name} was launched on none of the paths")
        source = (SRC_B1 if name.startswith("segmented_histogram") else
                  SRC if name == "lut_eval" else SRC_FUSED)
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=launches,
                         launches_by_path={p["path"]: p["launches"][name]
                                           for p in paths},
                         **measured[name]))
    eight = next(p for p in paths if p["path"] == f"nchains={NCHAINS}")
    for p in paths:
        if "toys" in p:
            print(f"path {p['path']}: {p['cli_seconds']!r} s, "
                  + (f"{p['toy_fits'] / p['cli_seconds']!r} toy fits/s "
                     f"({p['toys']} toys), " if p["toys"] else "")
                  + f"{p['solver']['syncs']} host reads of the solver on "
                  f"{smi}")
            continue
        extra = (f", {p['updates_per_sec']!r} parameter updates/s"
                 if p["updates_per_sec"] else "")
        if p["replica_steps_per_sec"]:
            extra += f", {p['replica_steps_per_sec']!r} replica-steps/s"
        if p["path"].startswith("sharded"):
            extra += (f"; {NEXP} experiments x {CPE} chains, beside the "
                      f"{NCHAINS}-chain path's {eight['steps_per_sec']!r}")
        print(f"path {p['path']}: {p['steps_per_sec']!r} chain-steps/s "
              f"({p['nsteps']} steps x {p['nchains']} chain(s){extra}) on "
              f"{smi}")
    print(json.dumps({"tempered_split": split, "mle_card_vs_cpu": mle_check}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
