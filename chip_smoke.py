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
       B2 lut_eval, through the read bins' plan (kernels.LutPlan), as
          the paths call it: the reference example's LUT (2 signals x
          its events, 10 bins), 8 chains x 2 signals on its 2 read-bin
          rows, 2 signals x 1M events x 1000 bins, 16 rows on 2 read-
          bin rows at that size, and rows of 60,000 bins (past the
          shared-memory budget), each in its own form and in the L1
          form, equal bit for bit to the plain version, NaN and 0
          sentinels in place; each shape's times (back to back through
          the plan and through lut_eval, on the card, plain), torch.
          gather's and the bound; EvalHist.eval (B1 + B2) on signal1's
          500k rows;
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
     Then signal1 as a KDE: "kde": true (grid rows, 5,000 steps),
     "kde_exact": true (the density at the events, 1,000 steps) and
     --sampler hmc on it (20 steps), each on the stepper (B1 with
     signal1 an empty segment, then B2, a step); the default fit on
     .sxnt tables written by python -m sxmc_tpu_torch.io.convert (its
     limit equal to the .npz fit's bit for bit); 8 lock-step chains
     with pool_adaptation through the library (every chain's widths
     equal after each burn-in phase; B3-batched once, B4-batched three
     times): 45 paths.  Beside them (kde_and_pooled) B1 on the KDE
     layout against its plain version, one exact KDE evaluation against
     device="cpu" (KDE_TOL), its card ms and peak memory, the exact-KDE
     HMC gradient (finite, nonzero in both systematics) and a KDE step's
     host share.
     The MLE of the example with the kernels is held against
     device="cpu" on the same data (best-fit NLL within NLL_TOL; free
     rates, profile limit and Asimov limit within 1e-3 relative), and
     the toys' dNLL with B2 against lut_eval_plain on the card;
     then the last modules: B1's autotuner (a reduced --record sweep of
     ops.autotune.shapes into this run's cache under build/autotune/,
     its table printed, every swept grid held against B1's plain
     version, the wrapper's fresh plan equal to each verdict); the
     multi-process ensemble (two CLI processes with --num-processes 2
     --coordinator 127.0.0.1:<port> on cuda:0, 4 experiments: limits
     equal to one process's run_multihost_ensemble bit for bit, each
     process's launches exact); and the device mesh with its shards on
     the one card: the event-sharded chain at 2 and 4 shards (summed B1
     counts equal unsharded B1, the initial NLL within NLL_TOL, a
     500-step walk equal to the unsharded stepper's decisions on the
     same draws, k B1 and k B2 a step), the bin-sharded build and eval
     at 100 bins, FeldmanCousins and the pull study on a 2-shard mesh
     and the sharded ensemble on a 2-shard exp mesh, each equal to its
     unsharded run: 50 paths;
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
HMC_STEPS = 200        # the gradient samplers' cut (host-paced: 17
NUTS_STEPS = 150       # evaluations an HMC step, a tree's leaves a NUTS one)
STRETCH_STEPS = 1_000  # the stretch move's cut (two batched NLLs a step)
NWALKERS = 16          # the stretch default at 4 parameters: max(2 * 4 + 2, 16)
CKPT_STEPS = 5_000     # --checkpoint-steps of the checkpointed Metropolis paths
GRAD_CKPT_STEPS = 50   # ... of the checkpointed HMC path
STRETCH_CKPT_STEPS = 250  # ... of the checkpointed stretch path
CPU_STEPS = 8          # HMC warmup steps held against device="cpu"
KILL_AFTER = 7         # segments before the kill of the kill-and-resume run
KDE_STEPS = 5_000      # the KDE paths' cuts (the stepper: host-paced, and
KDE_EXACT_STEPS = 1_000  # the exact rows 1,464 events x 500k samples a step)
KDE_HMC_STEPS = 20     # 10 warmup, 10 kept: 17 exact evaluations a step
KDE_TOL = 1e-4         # exact KDE density, the card against device="cpu"

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


# B2's shapes (PERF.md's table): the example's LUT; the 8 chains x 2
# signals rows of evaluate_batch (hmc 8 chains, stretch) sharing its 2
# read-bin rows; 2 signals x 1M events x 1,000 bins; 16 rows sharing 2
# read-bin rows at that size; and rows of 60,000 bins (a 3-D layout
# past the shared-memory budget: the L1 form by shape).
B2_BIG_EVENTS, B2_BIG_BINS, B2_WIDE_BINS = 1_000_000, 1000, 60_000


def b2_cases(torch, st, rb, theta, thetas) -> dict:
    """B2's shapes: name -> (counts, norms, read bins, bin volume)."""
    dev = rb.device
    hists, norms = st.histograms(theta)
    hb, nb = st.histograms_batch(thetas)
    cases = {
        "a: 2 x 1,464 events x 10 bins": (hists, norms, rb, st.bin_volume),
        "b: 16 rows on 2 read-bin rows, 1,464 x 10": (
            hb.reshape(-1, hb.shape[-1]).contiguous(), nb.reshape(-1),
            rb, st.bin_volume)}
    gen = torch.Generator(dev).manual_seed(9)
    rbb = torch.randint(-2, B2_BIG_BINS, (2, B2_BIG_EVENTS), generator=gen,
                        device=dev, dtype=torch.int32)
    for tag, nseg in (("c: 2 x 1M events x 1,000 bins", 2),
                      ("d: 16 rows on 2 read-bin rows, 1M x 1,000", 16)):
        cnt = torch.randint(0, 5000, (nseg, B2_BIG_BINS), generator=gen,
                            device=dev).to(torch.float32)
        cases[tag] = (cnt, cnt.sum(dim=1), rbb, 0.01)
    cnt = torch.randint(0, 50, (16, B2_WIDE_BINS), generator=gen,
                        device=dev).to(torch.float32)
    rbw = torch.randint(-2, B2_WIDE_BINS, (2, rb.shape[1]), generator=gen,
                        device=dev, dtype=torch.int32)
    cases["e: 16 rows on 2, 1,464 x 60,000 bins"] = (cnt, cnt.sum(dim=1),
                                                      rbw, 0.01)
    return cases


def b2_measure(torch, kernels, counts, norms, rb, bv, reps: int) -> dict:
    """One B2 shape: the kernel's ms with calls back to back (CUDA events;
    through the read bins' plan, as the paths call it, in turns with
    torch.gather's: gather, plan, plan, gather; and through lut_eval,
    which makes a plan a call; a tree without plans has only lut_eval),
    its ms on the card (torch.profiler), the plain version's ms,
    torch.gather's (the same gather without the division and the
    sentinels) ms and card ms, and the bound (bytes: each read bin read
    once, each table value and norm once, each output written once)."""
    nseg, total = counts.shape
    rows, nev = rb.shape
    via_lut = lambda: kernels.lut_eval(counts, norms, rb, bv)  # noqa: E731
    call = via_lut
    if hasattr(kernels, "LutPlan"):
        call = lambda p=kernels.LutPlan(rb, bv): p(counts, norms)  # noqa
    flat = counts.reshape(-1)
    idx = (torch.arange(nseg, device=rb.device)[:, None] * total
           + rb.repeat(nseg // rows, 1).clamp(0, total - 1).to(torch.int64)
           ).reshape(-1)
    gather = lambda: torch.gather(flat, 0, idx)  # noqa: E731
    ms, library_ms = in_turns(torch, gather, call, reps, reps)
    out = {"ms": ms, "lut_eval_ms": cuda_ms(torch, via_lut, reps),
           "card_ms": device_ms(torch, call, reps, ("sx_eval_lut_kernel",)),
           "plain_ms": cuda_ms(torch, lambda: kernels.lut_eval_plain(
               counts, norms, rb, bv), max(reps // 10, 5)),
           "library_ms": library_ms,
           "library_card_ms": device_ms(torch, gather, reps, ("gather",)),
           **bound(4.0 * (nseg * total + nseg + rows * nev + nseg * nev),
                   float(nseg * nev))}
    del idx
    return out


def check_b2(torch, kernels, st, rb, theta, thetas) -> dict:
    """B2 at every shape in both forms (staged and L1: the plan at a
    budget of 0 takes the L1 form at any shape), each equal to
    lut_eval_plain bit for bit (NaN and 0 sentinels in place); then the
    times of each shape's own form (b2_measure).  Returns the kernels
    line's entry: the example shape's numbers, and every shape's."""
    shapes = {}
    for name, (cnt, nrm, rbs, bv) in b2_cases(torch, st, rb, theta,
                                               thetas).items():
        want = kernels.lut_eval_plain(cnt, nrm, rbs, bv)
        forms = {}
        for tag, plan in (("own", kernels.LutPlan(rbs, bv)),
                          ("l1", kernels.LutPlan(rbs, bv, budget=0))):
            got = plan(cnt, nrm)
            torch.cuda.synchronize()
            err = lut_equal(torch, got, want)
            forms[tag] = plan.form(*cnt.shape)
        check(not forms["l1"]["staged"], f"B2 {name}: L1 form not taken")
        big = rbs.numel() * cnt.shape[0] // rbs.shape[0] > 1e6
        res = b2_measure(torch, kernels, cnt, nrm, rbs, bv, 50 if big
                         else 200)
        res.update(max_abs_err=err, form=forms["own"], l1_form=forms["l1"],
                   l1_card_ms=device_ms(torch, lambda p=kernels.LutPlan(
                       rbs, bv, budget=0): p(cnt, nrm), 50 if big else 200,
                       ("sx_eval_lut_kernel",)))
        print(f"B2 lut_eval, {name}: equal to plain in both forms ({forms}); "
              f"kernel {res['ms']:.4f} ms back to back (lut_eval "
              f"{res['lut_eval_ms']:.4f}), on the card {res['card_ms']} ms "
              f"(L1 form {res['l1_card_ms']}), bound {res['bound_ms']:.5f} ms"
              f" ({res['bound_by']}), plain {res['plain_ms']:.4f} ms, "
              f"torch.gather {res['library_ms']:.4f} ms (on the card "
              f"{res['library_card_ms']} ms)")
        shapes[name] = res
    a = shapes[next(iter(shapes))]
    return {"max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
            "ms": a["ms"], "plain_ms": a["plain_ms"],
            "library_ms": a["library_ms"], "device_ms": a["card_ms"],
            "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
            "shapes": shapes}


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

    # B2 at its shapes, in both forms.
    b2 = check_b2(torch, kernels, st, rb, theta, thetas)

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


# The gradient samplers, the stretch move and the checkpointed runners.
# An HMC evaluation (the potential and its gradient) is B1 + B2 (B1-
# batched + B2 for lock-step chains, B1 alone binned): 17 a step (the
# gradient at its start, one a leapfrog) and one for the start; NUTS's
# count is its trees' (1 a step and one a leaf), which the run reports
# (``evaluations``); the stretch move is one B1-batched + B2 for the
# initial cloud and two a step (each half of the walkers).  Every path
# draws its fake data with B1.  A checkpointed fit runs one chain: B3
# for the initial NLL, then one B4/B5 launch a segment (100,000 steps at
# CKPT_STEPS a segment: 20); a checkpointed ladder one B4-tempered launch
# up to each step that closes a swap interval of the global step count
# (a segment boundary ends one early).
HMC = {"sampler": "hmc"}
NUTS = {"sampler": "nuts"}
STRETCH = {"sampler": "stretch"}
GRAD_EVALS = 17


def hmc_launches(nsteps: int, batched: bool = False,
                 binned: bool = False) -> dict:
    n = 1 + GRAD_EVALS * nsteps
    if binned:
        return {"segmented_histogram": 1 + n}
    if batched:
        return {"segmented_histogram": 1, "segmented_histogram_batched": n,
                "lut_eval": n}
    return {"segmented_histogram": 1 + n, "lut_eval": n}


def nuts_launches(fit: dict) -> dict:
    return {"segmented_histogram": 1 + fit["evaluations"],
            "lut_eval": fit["evaluations"]}


def stretch_launches(nsteps: int) -> dict:
    return {"segmented_histogram": 1,
            "segmented_histogram_batched": 1 + 2 * nsteps,
            "lut_eval": 1 + 2 * nsteps}


def segments(nsteps: int, segment: int):
    """(global start, length) of a checkpointed Metropolis-type fit's
    segments: burn-in phases of a fifth, each ending a segment."""
    nburn = int(nsteps * 0.2)
    bounds = [nburn, 2 * nburn, nsteps]
    total, out = 0, []
    while total < nsteps:
        bound = next(b for b in bounds if total < b)
        n = min(segment, bound - total)
        out.append((total, n))
        total += n
    return out


def checkpointed_tempered_launches(nsteps: int, segment: int) -> int:
    launches = 0
    for start, n in segments(nsteps, segment):
        a = 0
        while a < n:
            a = min(a + SWAP_EVERY - (start + a) % SWAP_EVERY, n)
            launches += 1
    return launches


def kept_rows(sampler: str, nsteps: int) -> int:
    """Rows a chain (a stretch ensemble) keeps."""
    if sampler in ("hmc", "nuts"):
        return nsteps - max(int(nsteps * 0.2), 10)
    if sampler == "stretch":
        return (nsteps - int(nsteps * 0.2)) * NWALKERS
    return nsteps - 2 * int(nsteps * 0.2)


CKPT = ["--checkpoint-steps", str(CKPT_STEPS)]
CKPT_SEGMENTS = len(segments(FULL_STEPS, CKPT_STEPS))
PATHS += [
    ("hmc", HMC, ["--sampler", "hmc"], HMC_STEPS, hmc_launches(HMC_STEPS)),
    ("hmc, nchains=8", dict(HMC, nchains=NCHAINS), ["--sampler", "hmc"],
     HMC_STEPS, hmc_launches(HMC_STEPS, batched=True)),
    ("hmc, binned", HMC, ["--sampler", "hmc", "--binned"], HMC_STEPS,
     hmc_launches(HMC_STEPS, binned=True)),
    ("nuts", NUTS, ["--sampler", "nuts"], NUTS_STEPS, nuts_launches),
    ("stretch", STRETCH, ["--sampler", "stretch"], STRETCH_STEPS,
     stretch_launches(STRETCH_STEPS)),
    ("stretch, nchains=2", dict(STRETCH, nchains=2), ["--sampler", "stretch"],
     STRETCH_STEPS, stretch_launches(STRETCH_STEPS)),
    ("checkpointed", {}, CKPT, FULL_STEPS,
     {"segmented_histogram": 1, "fused_nll": 1, "fused_segment": CKPT_SEGMENTS}),
    ("checkpointed, full_cov", {"proposal": "full_cov"}, CKPT, FULL_STEPS,
     {"segmented_histogram": 1, "fused_nll": 1,
      "fused_segment_tril": CKPT_SEGMENTS}),
    ("checkpointed, rate_substeps=4", {"rate_substeps": RATE_SUBSTEPS},
     CKPT, FULL_STEPS,
     {"segmented_histogram": 1, "fused_nll": 1, "blocked_segment": CKPT_SEGMENTS}),
    ("checkpointed, tempered", TEMPERED, ["--sampler", "tempered"] + CKPT,
     FULL_STEPS,
     {"segmented_histogram": 1, "segmented_histogram_batched": 1,
      "lut_eval": 1, "fused_segment_tempered":
          checkpointed_tempered_launches(FULL_STEPS, CKPT_STEPS)}),
    ("checkpointed, hmc", HMC, ["--sampler", "hmc", "--checkpoint-steps",
                                str(GRAD_CKPT_STEPS)], HMC_STEPS,
     hmc_launches(HMC_STEPS)),
    ("checkpointed, stretch", STRETCH,
     ["--sampler", "stretch", "--checkpoint-steps", str(STRETCH_CKPT_STEPS)],
     STRETCH_STEPS, stretch_launches(STRETCH_STEPS)),
]


# KDE signals and the .sxnt event store.  signal1 declared a KDE ("kde":
# grid rows; "kde_exact": the density at the events): the stepper, each
# step B1 (signal2's rows beside signal1's empty segment) and B2, the KDE
# rows plain PyTorch; B1 also draws the fake data, and B1 + B2 give the
# initial NLL.  HMC on the exact KDE: hmc_launches.  The .sxnt path is
# the default fit on the tables converted by python -m
# sxmc_tpu_torch.io.convert: the default path's launches, and its limit
# bit for bit (kde_and_pooled).
KDE = {"kde": True}
KDE_EXACT = {"kde_exact": True}


def kde_launches(nsteps: int) -> dict:
    return {"segmented_histogram": nsteps + 2, "lut_eval": nsteps + 1}


PATHS += [
    ("kde", KDE, [], KDE_STEPS, kde_launches(KDE_STEPS)),
    ("kde_exact", KDE_EXACT, [], KDE_EXACT_STEPS,
     kde_launches(KDE_EXACT_STEPS)),
    ("kde_exact, hmc", dict(KDE_EXACT, **HMC), ["--sampler", "hmc"],
     KDE_HMC_STEPS, hmc_launches(KDE_HMC_STEPS)),
    ("sxnt", {"sxnt": True}, [], FULL_STEPS,
     {"segmented_histogram": 1, "fused_nll": 1, "fused_segment": 3}),
]


def sxnt_tables(workdir: str, names) -> list:
    """``names`` (.npz tables in ``workdir``) converted to .sxnt by the
    port's converter, one process a table, all started together (each
    spends most of its time importing torch); returns the .sxnt names."""
    outs = [n[:-len(".npz")] + ".sxnt" for n in names]
    t0 = time.perf_counter()
    procs = [(n, subprocess.Popen(
        [sys.executable, "-m", "sxmc_tpu_torch.io.convert",
         os.path.join(workdir, n), os.path.join(workdir, o)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for n, o in zip(names, outs)
        if not os.path.exists(os.path.join(workdir, o))]
    try:
        for n, proc in procs:
            so, se = proc.communicate(timeout=300)
            check(proc.returncode == 0, f"convert {n}: {so}{se}")
            print(f"{so.strip()} ({time.perf_counter() - t0:.2f} s)")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


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
    if edits.get("kde") or edits.get("kde_exact"):
        cfg["signals"]["signal1"].update(
            kde=True, kde_exact=bool(edits.get("kde_exact")))
    if edits.get("sxnt"):
        sigs = list(cfg["signals"].values())
        names = sxnt_tables(workdir, [sig["filename"] for sig in sigs])
        for sig, name in zip(sigs, names):
            sig["filename"] = name
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
        with open(os.path.join(out, "example_metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        failed = [r for r in recs if r["event"] == "experiment_failed"]
        check(not failed, f"{tag}: an experiment failed: {failed}")
        fit = next(r for r in recs if r["event"] == "experiment_fit")
        if callable(expect):
            expect = expect(fit)
        want = {k: expect.get(k, 0) for k in counts}
        check(counts == want, f"{tag}: launches {counts}, expected {want}")
        limits = [r["upper"] for r in recs
                  if r["event"] == "experiment_limit"]
        check(len(limits) == 1 and all(math.isfinite(x) for x in limits),
              f"{tag}: limits {limits}")
        result = next(r for r in recs if r["event"] == "experiment_result")
        # The gradient samplers' statistic aims at 0.8 and may reach 1.
        top = 1.0 if sampler in ("hmc", "nuts") else 0.95
        check(0.02 < fit["accept_rate"] <= top,
              f"{tag}: acceptance rate {fit['accept_rate']}")
        ckpt = "--checkpoint-steps" in flags
        if ckpt:
            check(not [n for n in os.listdir(out) if n.endswith(".ckpt.npz")],
                  f"{tag}: a checkpoint file was left")
        best = result["best_fit"]
        check(all(math.isfinite(v) for v in best.values()),
              f"{tag}: best fit {best}")
        # The fake data is drawn at the nominal rates: the fitted signal1
        # rate sits near 1 (about 1000 expected events, ~5% statistical).
        check(0.7 < best["signal1"] < 1.3,
              f"{tag}: best-fit signal1 {best['signal1']}")
        # The tempered sampler returns its cold chain alone, a
        # checkpointed fit one chain.
        nch = 1 if ckpt or sampler == "tempered" else edits.get("nchains", 1)
        nkeep = kept_rows(sampler, nsteps)
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
        walkers = (fit["steps_per_sec"] * NWALKERS if sampler == "stretch"
                   else None)
        leapfrogs = fit.get("leapfrogs_per_step")
        print(f"path {tag}: limit {limits[0]:.6g}, best fit {best}, accept "
              f"rate {fit['accept_rate']:.4f}, {nsteps} "
              f"{'cycles' if m else 'steps'} x {nch} chain(s) in "
              f"{fit['wall_seconds']:.3f} s = {fit['steps_per_sec']!r} "
              f"chain-{'cycles' if m else 'steps'}/s"
              + (f" ({updates!r} parameter updates/s)" if m else "")
              + (f" ({replica!r} replica-steps/s)" if replica else "")
              + (f" ({walkers!r} walker-steps/s)" if walkers else "")
              + (f", {leapfrogs!r} leapfrogs a step" if leapfrogs else "")
              + f", whole run {wall:.2f} s; launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        results.append({"path": tag, "nsteps": nsteps, "nchains": nch,
                        "steps_per_sec": fit["steps_per_sec"],
                        "updates_per_sec": updates,
                        "replica_steps_per_sec": replica,
                        "walker_steps_per_sec": walkers,
                        "leapfrogs_per_step": leapfrogs,
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
    kernel = kernels.LutPlan.__call__
    kernels.LutPlan.__call__ = lambda plan, c, n: kernels.lut_eval_plain(
        c, n, plan.read_bins, plan.bin_volume)
    try:
        want = toy_dnll_batch(mle, r_values, rb, 0, mle._free_rates)
    finally:
        kernels.LutPlan.__call__ = kernel
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


def example_sampler(torch, cls, config_path: str, workdir: str, device):
    """``cls`` (a sampler of the port) for the example on ``device``, with
    the fake dataset of seed 3 set."""
    from sxmc_tpu_torch.fitconfig import FitConfig
    from sxmc_tpu_torch.generator import make_fake_dataset

    fc = FitConfig.from_json_file(config_path, data_root=workdir)
    s = cls(fc.sources, fc.signals, fc.systematics, fc.observables,
            device=torch.device(device))
    data = make_fake_dataset(torch.Generator().manual_seed(3), fc.signals,
                             fc.systematics, fc.observables, stack=s.stack)
    s.stack.set_data(data)
    return s, data


def check_hmc_cpu(torch, kernels, config_path: str, workdir: str) -> dict:
    """HMC with the kernels against device="cpu" (the plain versions) on
    the same data and the same injected draws: CPU_STEPS warmup steps
    from the start, every state within 1e-4 relative and 1e-6 absolute
    (the tolerance of the CPU tests against the JAX package: float32
    reductions in another order over 16 leapfrogs a step), the
    potential within NLL_TOL; the card's launches exactly 1 + 17 a step
    of B1 and of B2."""
    from sxmc_tpu_torch.mcmc import hmc

    gen = torch.Generator().manual_seed(21)
    mom, u = torch.randn(CPU_STEPS, 4, generator=gen), torch.rand(
        CPU_STEPS, generator=gen)
    out = {}
    t0 = time.perf_counter()
    for dev in ("cuda", "cpu"):
        s, _ = example_sampler(torch, hmc.HMC, config_path, workdir, dev)
        rb = s.stack.read_bins
        fns = s._fns(rb)
        kernels.reset_launch_counts()
        carry = hmc.initial_warm_carry(s, rb, fns)
        carry, qs = hmc.warmup_segment(s, carry, rb, (mom.to(dev),
                                                      u.to(dev)), fns)
        out[dev] = (qs.cpu().numpy(), float(carry[1]), float(carry[2]),
                    kernels.launch_counts())
    qs_g, u_g, le_g, counts = out["cuda"]
    qs_c, u_c, le_c, _ = out["cpu"]
    diff = np.abs(qs_g - qs_c)
    rel = float(np.max(diff / np.maximum(np.abs(qs_c), 1e-6)))
    close = bool(np.all(diff <= 1e-4 * np.abs(qs_c) + 1e-6))
    n = 1 + GRAD_EVALS * CPU_STEPS
    want = {k: 0 for k in counts}
    want.update(segmented_histogram=n, lut_eval=n)
    check(counts == want, f"HMC card vs CPU: launches {counts}, want {want}")
    check(close and abs(u_g - u_c) <= NLL_TOL,
          f"HMC card vs CPU: states {rel} relative, {float(diff.max())} "
          f"absolute, potential {u_g!r} vs {u_c!r}")
    moved = int((np.abs(np.diff(qs_c, axis=0)).sum(1) > 0).sum())
    print(f"HMC card vs CPU on the example, {CPU_STEPS} warmup steps with "
          f"the same draws: max state difference {float(diff.max()):.3g} "
          f"absolute, {rel:.3g} relative, "
          f"potential {u_g!r} vs {u_c!r}, log step size {le_g!r} vs "
          f"{le_c!r}, {moved} of {CPU_STEPS - 1} steps moved "
          f"({time.perf_counter() - t0:.1f} s)")
    return {"state_rel": rel, "state_abs": float(diff.max()),
            "potential_abs": abs(u_g - u_c),
            "steps": CPU_STEPS, "moved": moved}


def kill_and_resume(torch, kernels, config_path: str, workdir: str) -> dict:
    """A checkpointed default fit on the card (the example, FULL_STEPS at
    CKPT_STEPS a segment), killed after KILL_AFTER segments and resumed
    from its file: its kept samples and NLLs equal the uninterrupted
    checkpointed fit's bit for bit; the launches of the two parts add up
    to the uninterrupted fit's (B3 once, one B4 a segment)."""
    from sxmc_tpu_torch import checkpoint
    from sxmc_tpu_torch.mcmc.metropolis import MCMC

    mcmc, data = example_sampler(torch, MCMC, config_path, workdir, "cuda")

    class Killed(Exception):
        pass

    def fit(path):
        return checkpoint.run_checkpointed(
            mcmc, data, FULL_STEPS, 0.2, segment_steps=CKPT_STEPS,
            checkpoint_path=path, seed=11)

    kernels.reset_launch_counts()
    full = fit(os.path.join(workdir, "full.ckpt.npz"))
    n_full = kernels.launch_counts()
    save = checkpoint.save_chain_state
    calls = {"n": 0}

    def killing_save(path, state):
        save(path, state)
        calls["n"] += 1
        if calls["n"] == KILL_AFTER:
            raise Killed()

    path = os.path.join(workdir, "killed.ckpt.npz")
    kernels.reset_launch_counts()
    checkpoint.save_chain_state = killing_save
    try:
        fit(path)
        fail("kill and resume: the run was not killed")
    except Killed:
        pass
    finally:
        checkpoint.save_chain_state = save
    step = int(checkpoint.load_chain_state(path)["step"])
    resumed = fit(path)
    torch.cuda.synchronize()
    n_parts = kernels.launch_counts()
    same = (np.array_equal(resumed.samples, full.samples)
            and np.array_equal(resumed.nll_values, full.nll_values))
    check(same, "kill and resume: the resumed fit's samples differ")
    want = {k: 0 for k in n_full}
    want.update(segmented_histogram=0, fused_nll=1,
                fused_segment=CKPT_SEGMENTS)
    check(n_full == want and n_parts == want,
          f"kill and resume: launches {n_full} and {n_parts}, want {want}")
    print(f"kill and resume on the card: killed at step {step} of "
          f"{FULL_STEPS} (after {KILL_AFTER} segments), resumed: "
          f"{len(full.samples)} kept samples and NLLs bit for bit equal "
          f"to the uninterrupted checkpointed fit's; launches {n_parts}")
    return {"killed_at_step": step, "kept": len(full.samples),
            "bit_for_bit": same}


def profile_and_traces(torch, kernels, config_path: str, workdir: str):
    """--profile LOGDIR on the default fit (cut to SPLIT_STEPS steps)
    writes its Chrome trace, and ``python -m sxmc_tpu_torch.time_plot``
    on its likelihood space writes the trace plot (where matplotlib is
    installed: the H100 machine has none, and the CPU tests run it)."""
    from sxmc_tpu_torch import time_plot
    from sxmc_tpu_torch.cli import main as cli_main

    cfg = path_config(config_path, workdir, "profiled", {}, SPLIT_STEPS)
    out = os.path.join(workdir, "out_profiled")
    logdir = os.path.join(workdir, "profile")
    t0 = time.perf_counter()
    rc = cli_main([cfg, out, "--data-root", workdir, "--device", "cuda",
                   "--max-retries", "0", "--profile", logdir])
    wall = time.perf_counter() - t0
    check(rc == 0, f"--profile: cli returned {rc}")
    traces = [n for n in os.listdir(logdir) if n.endswith(".json")]
    check(len(traces) == 1, f"--profile: traces {traces}")
    with open(os.path.join(logdir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels_seen = sum(1 for e in events if e.get("cat") == "kernel")
    check(len(events) > 0, "--profile: an empty trace")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        png_bytes = None
        note = "time_plot not run: matplotlib is not installed here"
    else:
        lspace = os.path.join(out, "example_0.npz")
        check(time_plot.main([lspace, os.path.join(workdir, "traces")])
              == 0, "time_plot failed")
        png_bytes = os.path.getsize(os.path.join(workdir, "traces",
                                                 "traces.png"))
        check(png_bytes > 0, "time_plot: empty PNG")
        note = f"time_plot wrote {png_bytes} bytes"
    print(f"--profile: {traces[0]}, {len(events)} events ({kernels_seen} "
          f"kernel records), the profiled fit's run {wall:.2f} s; {note}")
    return {"trace_events": len(events), "kernel_records": kernels_seen,
            "png_bytes": png_bytes}


def device_spans(torch, fn, trace: str, what: str):
    """``fn()`` under torch.profiler (CUDA activity only), read from its
    chrome-trace export: the device operations ``[(start us, end us,
    name)]``, the union of their time (busy us) and the span from the
    first to the last."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        evs = json.load(f)["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    e.get("name", "")) for e in evs
                   if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy"))
    check(len(spans) > 0, f"{what} trace: no device operation recorded")
    busy_us, end = 0.0, spans[0][0]
    for a, b, _ in spans:  # the union of the device operations
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return spans, busy_us, max(b for _, b, _ in spans) - spans[0][0]


def kde_and_pooled(torch, kernels, config_path: str, workdir: str,
                   paths: list):
    """The slice's checks beside its CLI paths: the .sxnt fit's limit
    equal to the default fit's bit for bit (the same seed); on the
    exact-KDE example, B1 on the KDE stack's layout (signal1 an empty
    segment) against its plain version, one exact evaluation of the KDE
    (1,464 events x 500k samples) against device="cpu" on the same
    theta (KDE_TOL relative; NaN where out of domain in both), its card
    ms (CUDA events) and peak memory, the HMC potential's gradient in
    theta (finite and nonzero in both systematics); a KDE stepper step's
    wall, device time and host share (1 - busy / wall, 200 steps timed,
    50 under torch.profiler), grid and exact; then the pooled path: 8
    lock-step chains at full length through the library with
    pool_adaptation, every chain's widths equal after each burn-in
    phase, B3-batched once and B4-batched three times.  Returns the
    pooled path's record and the measurements."""
    from sxmc_tpu_torch.mcmc import metropolis
    from sxmc_tpu_torch.mcmc.hmc import HMC, _target
    from sxmc_tpu_torch.mcmc.metropolis import MCMC

    dev = torch.device("cuda")
    limits = {p["path"]: p["limit"] for p in paths}
    check(limits["sxnt"] == limits["default"],
          f"the .sxnt fit's limit {limits['sxnt']!r} is not the .npz "
          f"fit's {limits['default']!r}")
    print(f".sxnt fit: limit {limits['sxnt']!r}, the .npz fit's "
          f"{limits['default']!r}: equal bit for bit")
    out = {"sxnt_limit": limits["sxnt"], "npz_limit": limits["default"]}

    cfg = path_config(config_path, workdir, "kde check", KDE_EXACT,
                      FULL_STEPS)
    mcmc, _ = example_sampler(torch, MCMC, cfg, workdir, "cuda")
    st = mcmc.stack
    hs = st.hist_spec
    check(hs.seg_off[0] == hs.seg_off[1] == 0 and hs.seg_off[2] > 0,
          f"KDE stack layout: segment offsets {hs.seg_off}")
    theta = torch.tensor([0.003, 0.0005], device=dev)
    got = kernels.segmented_histogram(hs, st.samples, theta)
    want = kernels.segmented_histogram_plain(hs, st.samples, theta)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "B1 on the KDE layout differs from its plain version")
    i, kde = st._kde_exact[0]
    pts = st._kde_exact_state[0]
    samples = st._kde_samples[i]
    row, norm = kde.eval_at(pts, theta, samples=samples)
    row_c, norm_c = kde.eval_at(pts.cpu(), theta.cpu(),
                                samples=samples.cpu())
    row = row.cpu()
    nan = torch.isnan(row_c)
    rel = float(((row - row_c).abs()
                 / row_c.abs().clamp_min(1e-30))[~nan].max())
    check(torch.equal(torch.isnan(row), nan) and rel <= KDE_TOL
          and float(norm) == float(norm_c),
          f"exact KDE, card vs CPU: {rel} relative, norms {float(norm)} "
          f"and {float(norm_c)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    exact_ms = cuda_ms(torch, lambda: kde.eval_at(pts, theta,
                                                  samples=samples), 10)
    peak = torch.cuda.max_memory_allocated() - base
    centres = torch.as_tensor(kde._centers_pts, device=dev)
    grid_ms = cuda_ms(torch, lambda: kde.eval_at(centres, theta,
                                                 samples=samples), 50)
    print(f"KDE on the card ({samples.shape[1]} samples): B1 on its layout "
          f"equal to the plain version; exact at {pts.shape[0]} events "
          f"{exact_ms:.3f} ms (peak {peak / 2**20:.1f} MiB), at the "
          f"{centres.shape[0]} bin centres {grid_ms:.3f} ms; card vs CPU "
          f"{rel:.3g} relative")
    out.update(kde_exact_ms=exact_ms, kde_exact_peak_mib=peak / 2**20,
               kde_grid_ms=grid_ms, kde_card_vs_cpu_rel=rel)

    hmc, _ = example_sampler(torch, HMC, cfg, workdir, "cuda")
    t = _target(hmc, hmc.stack.read_bins)
    u, g = t.value_and_grad(t.q0)
    g = g.cpu()
    check(bool(torch.isfinite(g).all()) and bool((g[2:] != 0).all()),
          f"exact-KDE HMC: the potential's gradient {g.tolist()}")
    print(f"exact-KDE HMC: potential {float(u)!r}, gradient {g.tolist()}")
    out["kde_exact_hmc_grad"] = g.tolist()

    for tag, edits in (("grid", KDE), ("exact", KDE_EXACT)):
        cfg_t = path_config(config_path, workdir, f"kde step {tag}", edits,
                            FULL_STEPS)
        mc, _ = example_sampler(torch, MCMC, cfg_t, workdir, "cuda")
        rb = mc.stack.read_bins
        params, cur, width = metropolis.initial_state(mc, rb)
        gen = torch.Generator(dev).manual_seed(5)

        def steps(n):
            noise, u_ = metropolis.presample(gen, n, mc.nparameters, dev)
            return lambda: metropolis.run_segment(mc, params, cur, width, rb,
                                                  noise, u_)

        steps(20)()
        n = 200 if tag == "grid" else 50
        seg = steps(n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seg()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / n * 1e3
        nprof = 50 if tag == "grid" else 20
        spans, busy_us, _ = device_spans(
            torch, steps(nprof), os.path.join(workdir, f"kde_{tag}.json"),
            f"KDE {tag} step")
        busy_ms = busy_us / nprof / 1e3
        host = 1.0 - busy_ms / step_ms
        print(f"KDE {tag} step on the card: {step_ms:.3f} ms ("
              f"{1e3 / step_ms:.1f} steps/s), {len(spans) / nprof:.1f} "
              f"device operations and {busy_ms:.3f} ms of device time a "
              f"step: host share {host:.2%}")
        out[f"kde_{tag}_step"] = {"step_ms": step_ms, "busy_ms": busy_ms,
                                  "ops": len(spans) / nprof,
                                  "host_share": host}

    mcmc, data = example_sampler(torch, MCMC, config_path, workdir, "cuda")
    widths = []
    real = metropolis.pooled_retune

    def record(mc, width, phase_samples):
        new = real(mc, width, phase_samples)
        widths.append(new.cpu())
        return new

    metropolis.pooled_retune = record
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ls = mcmc(data, FULL_STEPS, 0.2, nchains=NCHAINS,
                  pool_adaptation=True,
                  generator=torch.Generator(dev).manual_seed(8))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
    finally:
        metropolis.pooled_retune = real
    want = {k: 0 for k in counts}
    want.update(fused_nll_batched=1, fused_segment_batched=3)
    check(counts == want, f"pooled: launches {counts}, expected {want}")
    check(len(widths) == 2 and all(bool((w == w[0]).all()) for w in widths),
          f"pooled: widths after the burn-in phases {widths}")
    nkeep = kept_rows("metropolis", FULL_STEPS)
    check(ls.samples.shape == (NCHAINS * nkeep, 4)
          and np.isfinite(ls.samples).all(),
          f"pooled: likelihood space {ls.samples.shape}")
    best = ls.get_best_fit()["signal1"].point_estimate
    check(0.7 < best < 1.3, f"pooled: best-fit signal1 {best}")
    rate = FULL_STEPS * NCHAINS / wall
    print(f"path pooled, nchains=8: widths equal across the chains after "
          f"both burn-in phases ({widths[0][0].tolist()}, then "
          f"{widths[1][0].tolist()}), accept rate "
          f"{mcmc.last_accept_rate:.4f}, {rate!r} chain-steps/s (whole "
          f"call {wall:.2f} s); launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    pooled = {"path": "pooled, nchains=8", "nsteps": FULL_STEPS,
              "nchains": NCHAINS, "steps_per_sec": rate,
              "updates_per_sec": None, "replica_steps_per_sec": None,
              "wall_seconds": wall, "launches": counts}
    return pooled, out


def hmc_host_costs(torch, kernels, config_path: str, workdir: str) -> dict:
    """What paces an HMC step on the card: the host's time to enqueue one
    B1 (one theta) and one B2 call (through the read bins' plan, as the
    step calls it, and through lut_eval) back to back (no
    synchronisation: the host clock over 200 calls each, after a
    warm-up), beside torch.gather over the same LUT; then 20 sampling steps under torch.profiler (CUDA
    activity only): device operations a step, busy time a step, and the
    card's idle share of the window (1 - busy / the span from the first
    device operation to the last)."""
    from sxmc_tpu_torch.mcmc import hmc

    s, _ = example_sampler(torch, hmc.HMC, config_path, workdir, "cuda")
    st = s.stack
    dev = torch.device("cuda")
    theta = torch.zeros(2, device=dev)
    hists, norms = st.histograms(theta)
    rb = st.read_bins
    idx = torch.clamp_min(rb, 0).to(torch.int64)

    def host_us(fn, reps=200):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        return t

    b1 = host_us(lambda: kernels.segmented_histogram(st.hist_spec,
                                                     st.samples, theta))
    plan = st.lut_plan(rb)
    b2 = host_us(lambda: plan(hists, norms))
    b2_lut_eval = host_us(lambda: kernels.lut_eval(hists, norms, rb,
                                                   st.bin_volume))
    gather = host_us(lambda: torch.gather(hists, 1, idx))
    fns = s._fns(rb)
    nsteps = 20
    gen = torch.Generator(dev).manual_seed(9)
    draws = s.presample(gen, nsteps)
    q = fns.q0
    u_q = fns.value(q)
    eps = torch.tensor(0.02, device=dev)
    inv_mass = fns.inv_mass0
    hmc.main_segment(s, q, u_q, eps, inv_mass, rb, s.presample(gen, 3), fns)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hmc.main_segment(s, q, u_q, eps, inv_mass, rb, draws, fns)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / nsteps * 1e3
    spans, busy_us, span_us = device_spans(
        torch, lambda: hmc.main_segment(s, q, u_q, eps, inv_mass, rb, draws,
                                        fns),
        os.path.join(workdir, "hmc_trace.json"), "HMC")
    b1_seen = sum(1 for sp in spans if "sx_hist_kernel" in sp[2])
    ops = len(spans) / nsteps
    idle = 1.0 - busy_us / span_us
    print(f"HMC step on the card: {step_ms:.3f} ms a step ({1e3 / step_ms:.1f}"
          f" steps/s, 17 evaluations), {ops:.1f} device operations and "
          f"{busy_us / nsteps:.1f} us of device time a step, the card idle "
          f"{idle:.2%} of the profiled window; host us to enqueue one call "
          f"back to back: B1 {b1:.2f}, B2 {b2:.2f} (lut_eval "
          f"{b2_lut_eval:.2f}), torch.gather {gather:.2f}"
          f" (the trace holds {b1_seen} of the window's "
          f"{GRAD_EVALS * nsteps} B1 launches)")
    return {"step_ms": step_ms, "device_ops_per_step": ops,
            "busy_us_per_step": busy_us / nsteps, "idle_share": idle,
            "b1_host_us": b1, "b2_host_us": b2,
            "b2_lut_eval_host_us": b2_lut_eval, "gather_host_us": gather}


# ------------------- the autotuner, the multi-process ensemble, the mesh

HERE = os.path.dirname(os.path.abspath(__file__))
AUTOTUNE_REPS = 10     # launches a CUDA graph of the reduced sweep holds
MH_NEXP = 4            # experiments of the two-process ensemble
MH_TIMEOUT = 600       # seconds a worker process may take
WALK_STEPS = SEGMENT_STEPS  # the event-sharded chain's walk
MESH_BINS = 100        # the bin-sharded example's energy bins


def autotune_phase(torch, kernels, config_path: str, workdir: str) -> dict:
    """B1's autotuner on the card: a reduced ``--record`` sweep (every
    candidate grid of ops.autotune.shapes, card time from CUDA graphs of
    AUTOTUNE_REPS launches) into the cache file that the environment
    names (build/autotune/, this run's copy of the shipped file), its
    table printed; every candidate grid timed and held against B1's
    plain version (exact counts); then the wrapper's plan for each shape,
    made afresh, must be the recorded verdict."""
    from sxmc_tpu_torch.ops import autotune

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    swept = autotune.record(dev, reps=AUTOTUNE_REPS)
    sweep_s = time.perf_counter() - t0
    cache = autotune.load_cache()
    checked = 0
    for name, (hs, x, th) in autotune.shapes(dev).items():
        nch = th.shape[0] if th.dim() == 2 else 1
        grids = autotune.candidate_grids(hs, nch, dev)
        check(len(swept[name]["times"]) == len(grids),
              f"autotune {name}: {len(swept[name]['times'])} of "
              f"{len(grids)} grids timed")
        want = kernels.segmented_histogram_plain(hs, x, th)
        for label in swept[name]["times"]:
            b, s = (int(w.split()[0]) for w in label.split(", "))
            got = kernels.launch_histogram_at(hs, x, th, nch, (b, s))
            got = tuple(g.reshape(w.shape) for g, w in zip(got, want))
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"autotune {name}: B1 at {label} differs from plain")
            checked += 1
        fresh = kernels.HistSpec.build(hs.nfields, hs.lower, hs.upper,
                                       hs.nbins, hs.systematics, hs.seg_off,
                                       hs.weighted)
        rec = cache[swept[name]["key"]]
        check(kernels.b1_grid(fresh, nch, dev) == (rec["blocks"],
                                                   rec["slots"]),
              f"autotune {name}: the plan ignores the verdict {rec}")
        print(f"autotune {name}: rule {tuple(swept[name]['rule'])} "
              f"{rec['heuristic_seconds'] * 1e3:.4f} ms, verdict "
              f"({rec['blocks']}, {rec['slots']}) {rec['seconds'] * 1e3:.4f}"
              f" ms on {autotune.card()}")
    path = autotune.cache_path()
    print(f"autotune: {checked} grids equal to B1's plain version; the "
          f"verdicts written to {path} (sweep {sweep_s:.2f} s)")
    with open(path) as f:
        return {"sweep_seconds": sweep_s, "grids_checked": checked,
                "file": json.load(f)}


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def multihost_phase(torch, kernels, config_path: str, workdir: str):
    """The multi-process ensemble on the one card: two processes of
    ``python -m sxmc_tpu_torch.cli ... --num-processes 2 --coordinator
    127.0.0.1:<free port> --process-id i`` (MH_NEXP experiments, both on
    cuda:0, a timeout each), their gathered limits equal to one
    process's ``run_multihost_ensemble`` bit for bit, each process's
    launches exact (B1 for each of its experiments' fake data, B3 for
    each one's initial NLL, one grouped B4 launch per phase)."""
    from sxmc_tpu_torch.fitconfig import FitConfig
    from sxmc_tpu_torch.parallel.multihost import run_multihost_ensemble

    dev = torch.device("cuda")
    cfg = path_config(config_path, workdir, "multihost",
                      {"nexperiments": MH_NEXP}, FULL_STEPS)
    fc = FitConfig.from_json_file(cfg, data_root=workdir)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    _, want = run_multihost_ensemble(fc, device=dev, verbose=False)
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    one = kernels.launch_counts()
    expect = {"segmented_histogram": MH_NEXP, "fused_nll": MH_NEXP,
              "fused_segment_grouped": 3}
    check(one == {k: expect.get(k, 0) for k in one},
          f"multihost, one process: launches {one}")
    out = os.path.join(workdir, "out_multihost")
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sxmc_tpu_torch.cli", cfg, out, "--data-root",
         workdir, "--device", "cuda", "--num-processes", "2",
         "--coordinator", coord, "--process-id", str(i)], env=env, cwd=HERE,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=MH_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        fail(f"multihost: a worker ran past {MH_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    two_wall = time.perf_counter() - t0
    for i, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"multihost: process {i} returned "
              f"{p.returncode}:\n{log[-3000:]}")
    recs = []
    for i in (0, 1):
        with open(os.path.join(out, f"example_metrics_{i}.jsonl")) as f:
            recs.append(json.loads(f.readline()))
    half = {"segmented_histogram": MH_NEXP // 2, "fused_nll": MH_NEXP // 2,
            "fused_segment_grouped": 3}
    total = dict.fromkeys(kernels.launch_counts(), 0)
    for i, r in enumerate(recs):
        check(r["experiments"] == list(range(i * 2, i * 2 + 2)),
              f"multihost: process {i} fitted {r['experiments']}")
        check(r["launches"] == half,
              f"multihost: process {i} launched {r['launches']}")
        check(r["limits"] == want.tolist(),
              f"multihost: process {i}'s limits {r['limits']} differ from "
              f"one process's {want.tolist()}")
        for k, v in r["launches"].items():
            total[k] += v
    check(all(0.8 < x < 1.5 for x in want), f"multihost: limits {want}")
    print(f"path multihost: 2 processes on one card, limits {want.tolist()} "
          f"equal to one process's bit for bit; walls: two processes "
          f"{two_wall:.2f} s (their fits {[round(r['wall_seconds'], 3) for r in recs]}"
          f" s, each with its start and build load), one process "
          f"{one_wall:.2f} s")
    base = {"nchains": MH_NEXP, "nsteps": FULL_STEPS, "updates_per_sec": None,
            "replica_steps_per_sec": None}
    return [dict(base, path="multihost, one process", launches=one,
                 wall_seconds=one_wall, cli_seconds=one_wall,
                 steps_per_sec=FULL_STEPS * MH_NEXP / one_wall),
            dict(base, path="multihost, two processes", launches=total,
                 wall_seconds=two_wall, cli_seconds=two_wall,
                 steps_per_sec=FULL_STEPS * MH_NEXP / two_wall)]


def _walk_presampler(torch, npar: int, seed: int):
    dev = torch.device("cuda")
    from sxmc_tpu_torch.mcmc import metropolis

    gen = torch.Generator(dev).manual_seed(seed)
    drawn = {}

    def presample(k, n):
        if (k, n) not in drawn:
            drawn[(k, n)] = metropolis.presample(gen, n, npar, dev)
        return drawn[(k, n)]

    return presample


def mesh_phase(torch, kernels, config_path: str, workdir: str):
    """The device mesh, its shards on the one card ([cuda:0] * k):
    run_sharded_chain at k = 2 and 4 (the summed B1 counts equal
    unsharded B1 exactly, the initial NLL within NLL_TOL of the
    unsharded stepper's and of B3, a WALK_STEPS-step walk equal to the
    unsharded stepper's decisions on the same draws, k B1 and k B2
    launches an evaluation); the bin-sharded build and eval of the
    example at MESH_BINS bins against the unsharded ones; FeldmanCousins
    and the pull study with a 2-shard mesh against the unsharded runs on
    the same toys; the sharded ensemble on a 2-shard exp mesh against the
    one-device batch."""
    from sxmc_tpu_torch.fitconfig import FitConfig
    from sxmc_tpu_torch.mcmc import metropolis
    from sxmc_tpu_torch.parallel import bin_sharded
    from sxmc_tpu_torch.parallel import mesh as mesh_lib
    from sxmc_tpu_torch.parallel.chain_sharded import (ShardedNLL,
                                                       run_sharded_chain)
    from sxmc_tpu_torch.parallel.ensemble import run_sharded_ensemble
    from sxmc_tpu_torch.stats.bias import pull_study
    from sxmc_tpu_torch.stats.feldman_cousins import FeldmanCousins
    from sxmc_tpu_torch.stats.mle import MLE

    dev = torch.device("cuda")
    results, report = [], {}
    mcmc, data = example_mcmc(torch, config_path, workdir)
    rb = mcmc.stack.read_bins
    ns = mcmc.nsources
    p0 = torch.as_tensor(mcmc.parameter_means, dtype=torch.float32,
                         device=dev)
    stepper = metropolis._chain_nll(mcmc, rb, allow_fused=False)
    ref0 = stepper(p0)
    b3 = metropolis._chain_nll(mcmc, rb)(p0)

    def nll_of(pair):
        return float(pair[0].double() + pair[1].double())

    # The unsharded stepper's walk on the draws the sharded walks take.
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    want = metropolis.run_chain(mcmc, rb, WALK_STEPS, int(WALK_STEPS * 0.2),
                                False, _walk_presampler(torch, 4, 31),
                                chain_nll=stepper)
    torch.cuda.synchronize()
    walls = {1: time.perf_counter() - t0}
    evals = WALK_STEPS + 1  # the initial NLL, then one a step
    counts = kernels.launch_counts()
    expect = {"segmented_histogram": evals, "lut_eval": evals}
    check(counts == {n: expect.get(n, 0) for n in counts},
          f"unsharded stepper walk: launches {counts}")
    for k in (2, 4):
        mesh = mesh_lib.make_mesh(event=k, devices=[dev] * k)
        nll = ShardedNLL(mcmc, rb, mesh)
        for th in ([0.0, 0.0], [0.01, -0.002], [-0.02, 0.001]):
            theta = torch.tensor(th, dtype=torch.float32, device=dev)
            got, ref = nll.histograms(theta), mcmc.stack.histograms(theta)
            check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
                  f"event-sharded chain, {k} shards: summed B1 counts differ "
                  f"at {th}")
        err0 = abs(nll_of(nll(p0)) - nll_of(ref0))
        check(err0 <= NLL_TOL and abs(nll_of(nll(p0)) - nll_of(b3))
              <= NLL_TOL, f"event-sharded chain, {k} shards: initial NLL "
              f"{nll_of(nll(p0))}, stepper {nll_of(ref0)}, B3 {nll_of(b3)}")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ls = run_sharded_chain(mcmc, data, WALK_STEPS, 0.2, mesh=mesh,
                               presampler=_walk_presampler(torch, 4, 31))
        torch.cuda.synchronize()
        walls[k] = time.perf_counter() - t0
        counts = kernels.launch_counts()
        expect = {"segmented_histogram": k * evals, "lut_eval": k * evals}
        check(counts == {n: expect.get(n, 0) for n in counts},
              f"event-sharded chain, {k} shards: launches {counts}")
        got = torch.as_tensor(np.stack(
            [ls.column(n) for n in mcmc.parameter_names], axis=1))
        same = (got == want[0].cpu()).all(dim=1)
        if not bool(same.all()):
            fail(f"event-sharded chain, {k} shards: decisions diverge from "
                 f"the unsharded stepper's at kept step "
                 f"{int((~same).nonzero()[0])}")
        nerr = float(np.abs(ls.nll_values - metropolis.nll_history_to_f64(
            want[1])).max())
        check(nerr <= NLL_TOL, f"event-sharded chain, {k} shards: NLL "
              f"history differs by {nerr}")
        report[f"chain {k} shards"] = {"initial_nll_err": err0,
                                       "nll_history_err": nerr,
                                       "wall_seconds": walls[k]}
        results.append({"path": f"event-sharded chain, {k} shards",
                        "nsteps": WALK_STEPS, "nchains": 1,
                        "steps_per_sec": WALK_STEPS / walls[k],
                        "updates_per_sec": None,
                        "replica_steps_per_sec": None,
                        "wall_seconds": walls[k], "cli_seconds": walls[k],
                        "launches": counts})
        print(f"path event-sharded chain, {k} shards on one card: "
              f"{WALK_STEPS} steps in {walls[k]:.3f} s (unsharded stepper "
              f"{walls[1]:.3f} s), decisions equal, initial NLL off by "
              f"{err0:.3g}, history by {nerr:.3g}; launches "
              f"{ {n: v for n, v in counts.items() if v} }")

    # The bin-sharded build and eval of the example at MESH_BINS bins.
    wide, _ = example_mcmc(torch, write_example_variant(
        config_path, workdir, bins=MESH_BINS), workdir, data)
    bmesh = bin_sharded.make_bin_mesh(devices=[dev] * 4)
    for th in ([0.0, 0.0], [0.01, -0.002]):
        theta = torch.tensor(th, dtype=torch.float32, device=dev)
        shards, norms = bin_sharded.bin_sharded_histograms(bmesh, wide.stack,
                                                           theta)
        h = torch.cat(shards, dim=1)[:, :wide.stack.total_nbins]
        ref_h, ref_n = wide.stack.histograms(theta)
        check(torch.equal(h, ref_h) and torch.equal(norms, ref_n),
              f"bin-sharded build at {th} differs from unsharded B1")
        lut = bin_sharded.bin_sharded_eval(bmesh, shards, norms,
                                           wide.stack.read_bins,
                                           wide.stack.bin_volume)
        lut_equal(torch, lut, wide.stack.evaluate(theta)[0])
    print(f"bin-sharded build and eval, {MESH_BINS} bins over 4 shards: "
          "equal to unsharded B1 and B2")

    # The tier with a 2-shard mesh, on the same toys as unsharded.
    fc = FitConfig.from_json_file(config_path, data_root=workdir)
    mle = MLE(fc.sources, fc.signals, fc.systematics, fc.observables,
              device=dev)
    tmesh = mesh_lib.make_mesh(exp=2, devices=[dev] * 2)
    grid = np.linspace(0.85, 1.15, FC_GRID)
    belts, pulls, tier_walls = [], [], []
    for m in (None, tmesh):
        t0 = time.perf_counter()
        belts.append(FeldmanCousins(mle, "signal1").build_belt(
            torch.Generator(dev).manual_seed(7), grid, ntoys=NTOYS, cl=0.9,
            mesh=m))
        pulls.append(pull_study(mle, NTOYS, torch.Generator(
            dev).manual_seed(9), mesh=m))
        torch.cuda.synchronize()
        tier_walls.append(time.perf_counter() - t0)
    check(np.array_equal(belts[0].dnll_toys, belts[1].dnll_toys)
          and np.array_equal(belts[0].crit, belts[1].crit),
          "FC belt on a 2-shard mesh differs from unsharded: max "
          f"{np.abs(belts[0].dnll_toys - belts[1].dnll_toys).max()}")
    check(np.array_equal(pulls[0].estimates, pulls[1].estimates)
          and np.array_equal(pulls[0].errors, pulls[1].errors),
          "pull study on a 2-shard mesh differs from unsharded")
    print(f"FC belt ({FC_GRID} x {NTOYS} toys) and pull study ({NTOYS} "
          f"toys) on a 2-shard mesh: equal to unsharded; walls "
          f"{tier_walls[1]:.3f} s (unsharded {tier_walls[0]:.3f} s)")
    report["tier walls"] = tier_walls

    # The sharded ensemble on a 2-shard exp mesh.
    ecfg = path_config(config_path, workdir, "mesh ensemble", SHARDED,
                       FULL_STEPS)
    efc = FitConfig.from_json_file(ecfg, data_root=workdir)
    runs = []
    for m in (None, mesh_lib.make_mesh(exp=2, devices=[dev] * 2)):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ls_e, lim = run_sharded_ensemble(efc, device=dev, verbose=False,
                                         mesh=m)
        torch.cuda.synchronize()
        runs.append((ls_e, lim, time.perf_counter() - t0,
                     kernels.launch_counts()))
    expect = {"segmented_histogram": NEXP, "fused_nll": NEXP}
    check(runs[0][3] == {n: dict(expect, fused_segment_grouped=3).get(n, 0)
                         for n in runs[0][3]},
          f"sharded ensemble, one device: launches {runs[0][3]}")
    check(runs[1][3] == {n: dict(expect, fused_segment_grouped=6).get(n, 0)
                         for n in runs[1][3]},
          f"sharded ensemble, 2 shards: launches {runs[1][3]}")
    check(runs[1][1] == runs[0][1] and all(
        np.array_equal(a.nll_values, b.nll_values)
        for a, b in zip(runs[0][0], runs[1][0])),
        f"sharded ensemble on a 2-shard mesh: limits {runs[1][1]}, one "
        f"device {runs[0][1]}")
    print(f"path sharded ensemble, 2-shard exp mesh: limits equal to the "
          f"one-device batch bit for bit; walls {runs[1][2]:.3f} s "
          f"(one device {runs[0][2]:.3f} s)")
    results.append({"path": "sharded ensemble, 2-shard exp mesh",
                    "nsteps": FULL_STEPS, "nchains": NEXP * CPE,
                    "steps_per_sec": FULL_STEPS * NEXP * CPE / runs[1][2],
                    "updates_per_sec": None, "replica_steps_per_sec": None,
                    "wall_seconds": runs[1][2], "cli_seconds": runs[1][2],
                    "launches": runs[1][3]})
    report["ensemble walls"] = [runs[0][2], runs[1][2]]
    return results, report


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
    # B1's verdicts: the shipped file, under this run's own cache in the
    # checkout (build/autotune/), which the autotune phase records anew;
    # nothing is read from or written to the home directory.
    cache = os.path.join(HERE, "build", "autotune", "autotune_h100.json")
    if os.path.exists(cache):
        os.remove(cache)
    os.environ["SXMC_TPU_TORCH_AUTOTUNE_CACHE"] = cache
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

    walls = {}

    def phase(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        walls[fn.__name__] = round(time.perf_counter() - t, 2)
        return out

    with tempfile.TemporaryDirectory() as workdir:
        config_path = write_example(workdir)
        args = (torch, kernels, config_path, workdir)
        measured = phase(check_kernels, *args)
        paths = phase(main_paths, *args)
        pooled, kde_checks = phase(kde_and_pooled, *args, paths)
        paths.append(pooled)
        paths += phase(sharded_paths, *args)
        stats = phase(stats_paths, *args)
        stats.append(phase(fc_path, *args))
        mle_check = phase(check_mle_cpu, *args)
        split = phase(tempered_split, torch, config_path, workdir)
        hmc_check = phase(check_hmc_cpu, *args)
        resume = phase(kill_and_resume, *args)
        profiled = phase(profile_and_traces, *args)
        host = phase(hmc_host_costs, *args)
        tuned = phase(autotune_phase, *args)
        paths += phase(multihost_phase, *args)
        mesh_paths, mesh_report = phase(mesh_phase, *args)
        paths += mesh_paths
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
        if p.get("walker_steps_per_sec"):
            extra += f", {p['walker_steps_per_sec']!r} walker-steps/s"
        if p.get("leapfrogs_per_step"):
            extra += f", {p['leapfrogs_per_step']!r} leapfrogs a step"
        if p["path"].startswith("sharded"):
            extra += (f"; {NEXP} experiments x {CPE} chains, beside the "
                      f"{NCHAINS}-chain path's {eight['steps_per_sec']!r}")
        print(f"path {p['path']}: {p['steps_per_sec']!r} chain-steps/s "
              f"({p['nsteps']} steps x {p['nchains']} chain(s){extra}) on "
              f"{smi}")
    print(json.dumps({"tempered_split": split, "mle_card_vs_cpu": mle_check,
                      "hmc_card_vs_cpu": hmc_check, "kill_and_resume": resume,
                      "profile": profiled, "hmc_host_costs": host,
                      "kde_sxnt_pooled": kde_checks, "mesh": mesh_report,
                      "autotune": tuned, "phase_seconds": walls}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
