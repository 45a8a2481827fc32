"""Grid and phase probe of the fused Metropolis kernel B4 on one H100.

    python3 probe_fused_grid.py [--nchains 1,8,32] [--steps 500] [--rows N]

from the root of a checkout, on a machine with one Hopper card.  On the
reference example's layout (``chip_smoke.write_example``: 2 signals x
500k MC rows, 10 bins, scale and resolution systematics; ``--rows N``
keeps the first N rows of each signal) it runs B4 segments of
lock-step chains through the C entry ``sx_fused`` (its unweighted
diagonal form), for each chain count:

  * the grid: the cooperative grid set by hand to 1, 2, 3 and 4 blocks
    per SM (in the order 1, 2, 3, 4, 4, 3, 2, 1), and once the grid that
    ``sx_fused_grid``'s rule picks; every grid must take the same accept
    decisions; microseconds per step of each;
  * the phase split of a step, on the rule's grid, by composition: the
    same segment with no MC samples (no
    rebuild work), with no events (no sweep work), and with both cut
    (the fixed cost: propose, clearing, flush, the two grid barriers,
    finish and accept).  Rebuild = full - no samples, sweep =
    full - no events; what is left of the full step beside the three is
    printed as the overlap.

The port always launches the rule's grid; this script only measures.
"""

import argparse
import ctypes
import dataclasses
import json
import sys
import tempfile

from chip_smoke import check, cuda_ms, fail, run, write_example

CUT_ROWS = 0  # MC rows a segment of the "no samples" runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nchains", default="1,8,32",
                    help="comma-separated chain counts")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--rows", type=int, default=0,
                    help="MC rows a signal (default: all 500,000)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    from sxmc_tpu_torch.fitconfig import FitConfig
    from sxmc_tpu_torch.generator import make_fake_dataset
    from sxmc_tpu_torch.mcmc.metropolis import MCMC, initial_state
    from sxmc_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as workdir:
        fc = FitConfig.from_json_file(write_example(workdir),
                                      data_root=workdir)
        mcmc = MCMC(fc.sources, fc.signals, fc.systematics, fc.observables,
                    device=dev)
    st = mcmc.stack
    st.set_data(make_fake_dataset(torch.Generator().manual_seed(3),
                                  fc.signals, fc.systematics,
                                  fc.observables, stack=st))
    hs, ns, rb = st.hist_spec, mcmc.nll_spec, st.read_bins
    n, npar = args.steps, mcmc.nparameters

    def rows(k, full=hs):
        """The first k rows of each segment: (spec, samples)."""
        idx = torch.cat([torch.arange(a, a + k, device=dev)
                         for a in full.seg_off[:-1]])
        return (dataclasses.replace(
            full, seg_off=tuple(k * d for d in range(full.ndyn + 1))),
            st.samples[:, idx].contiguous())

    samples = st.samples
    if args.rows:
        hs, samples = rows(args.rows)
    # The cut inputs: CUT_ROWS rows of each segment, no events.
    hs_cut, samples_cut = rows(CUT_ROWS)
    rb_cut = rb[:, :0].contiguous()

    lib = kernels._library()
    nsources = int(ns.st.nsources)
    cs_full = kernels._c_spec(hs, ns, nsources)
    cs_cut = kernels._c_spec(hs_cut, ns, nsources)
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    p = kernels._ptr
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    report = {"steps": n, "rows": hs.n, "card": smi, "by_chains": {}}
    for nch in (int(x) for x in args.nchains.split(",")):
        params, (hi, lo), width = initial_state(mcmc, rb, nch)
        nll0 = torch.stack([hi, lo], dim=-1).contiguous()
        gen = torch.Generator(dev).manual_seed(11)
        noise = torch.randn((n, nch, npar), generator=gen, device=dev)
        log_u = torch.log(torch.rand((n, nch), generator=gen, device=dev))
        rule = ctypes.c_int(0)
        kernels._check_cuda(lib, lib.sx_fused_grid(
            ctypes.byref(cs_full), nch, 0, ctypes.byref(rule)),
            "sx_fused_grid")
        scratch = torch.empty(2 * nch * (hs.ndyn * hs.total + hs.ndyn),
                              dtype=torch.int32, device=dev)
        partials = torch.empty(nch * 4 * nsm, dtype=torch.float64,
                               device=dev)
        s_out = torch.empty((n, nch, npar), dtype=torch.float32, device=dev)
        n_out = torch.empty((n, nch, 2), dtype=torch.float32, device=dev)
        a_out = torch.empty((n, nch), dtype=torch.float32, device=dev)

        def launch(nblocks, cs=cs_full, samples=samples, rbs=rb):
            err = lib.sx_fused(
                ctypes.byref(cs), nch, 0, 0, p(samples), p(st.hist_init),
                p(rbs), rbs.shape[1], p(params), p(nll0), p(width), None,
                p(noise), p(log_u), n, 0, p(scratch), p(partials), nblocks,
                p(s_out), p(n_out), p(a_out), kernels._stream(dev))
            kernels._check_cuda(lib, err, f"sx_fused on {nblocks} blocks")

        launch(rule.value)
        torch.cuda.synchronize()
        want_a, want_n = a_out.clone(), n_out.double().sum(-1)
        times = {}
        for per_sm in (1, 2, 3, 4, 4, 3, 2, 1):
            launch(per_sm * nsm)
            torch.cuda.synchronize()
            check(torch.equal(a_out, want_a),
                  f"{nch} chains, {per_sm} blocks per SM: accept decisions "
                  "differ")
            dnll = float((n_out.double().sum(-1) - want_n).abs().max())
            ms = cuda_ms(torch, lambda: launch(per_sm * nsm), 3)
            times.setdefault(per_sm, []).append(ms / n * 1e3)
            print(f"{nch} chain(s), {per_sm} blocks per SM: "
                  f"{ms / n * 1e3:.2f} us/step, |dNLL| {dnll:.3g} against "
                  "the rule's grid")

        g = rule.value
        split = {}
        for tag, kw in (("full", {}),
                        ("no samples", dict(cs=cs_cut, samples=samples_cut)),
                        ("no events", dict(rbs=rb_cut)),
                        ("fixed", dict(cs=cs_cut, samples=samples_cut,
                                       rbs=rb_cut)),
                        ("full again", {})):
            split[tag] = cuda_ms(torch, lambda: launch(g, **kw), 5) / n * 1e3
        full = (split["full"] + split["full again"]) / 2
        phases = {"rebuild": full - split["no samples"],
                  "sweep": full - split["no events"],
                  "fixed": split["fixed"]}
        phases["overlap"] = full - sum(phases.values())
        print(f"{nch} chain(s) x {hs.n} MC rows, rule {g // nsm} blocks "
              f"per SM ({g} blocks): "
              f"{full:.2f} us/step = rebuild {phases['rebuild']:.2f} + "
              f"sweep {phases['sweep']:.2f} + fixed {phases['fixed']:.2f} "
              f"+ overlap {phases['overlap']:.2f} (us; runs {split})")
        report["by_chains"][nch] = {
            "rule_blocks_per_sm": g // nsm, "rule_us_per_step": full,
            "us_per_step_by_blocks_per_sm": times, "split_us": phases,
            "runs_us": split}
    print(f"on {smi}")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
