"""Blocks-per-SM probe of the fused Metropolis kernel B4 on one H100.

    python3 probe_fused_grid.py [--nchains 8] [--steps 500]

from the root of a checkout, on a machine with one Hopper card.  On the
reference example's layout (``chip_smoke.write_example``: 2 signals x
500k MC rows, 10 bins, scale and resolution systematics) it runs one B4
segment of lock-step chains through the C entry ``sx_fused`` (its
unweighted diagonal form) with the
cooperative grid set by hand to 1, 2, 3 and 4 blocks per SM (in the
order 1, 2, 3, 4, 4, 3, 2, 1), and once with the grid that
``sx_fused_grid``'s rule picks.  It checks that every grid takes the
same accept decisions, and prints the microseconds per step of each.
The port always launches the rule's grid; this script only measures
the rule.
"""

import argparse
import ctypes
import json
import sys
import tempfile

from chip_smoke import check, cuda_ms, fail, run, write_example


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nchains", type=int, default=8)
    ap.add_argument("--steps", type=int, default=500)
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
    nch, n, npar = args.nchains, args.steps, mcmc.nparameters
    params, (hi, lo), width = initial_state(mcmc, rb, nch)
    nll0 = torch.stack([hi, lo], dim=-1).contiguous()
    gen = torch.Generator(dev).manual_seed(11)
    noise = torch.randn((n, nch, npar), generator=gen, device=dev)
    log_u = torch.log(torch.rand((n, nch), generator=gen, device=dev))

    lib = kernels._library()
    cs = kernels._c_spec(hs, ns, int(ns.st.nsources))
    rule = ctypes.c_int(0)
    kernels._check_cuda(lib, lib.sx_fused_grid(ctypes.byref(cs), nch, 0,
                                               ctypes.byref(rule)),
                        "sx_fused_grid")
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    scratch = torch.empty(2 * nch * (hs.ndyn * hs.total + hs.ndyn),
                          dtype=torch.int32, device=dev)
    partials = torch.empty(nch * 4 * nsm, dtype=torch.float64, device=dev)
    s_out = torch.empty((n, nch, npar), dtype=torch.float32, device=dev)
    n_out = torch.empty((n, nch, 2), dtype=torch.float32, device=dev)
    a_out = torch.empty((n, nch), dtype=torch.float32, device=dev)
    p = kernels._ptr

    def launch(nblocks):
        err = lib.sx_fused(
            ctypes.byref(cs), nch, 0, 0, p(st.samples), p(st.hist_init),
            p(rb), rb.shape[1], p(params), p(nll0), p(width), None, p(noise),
            p(log_u), n, 0, p(scratch), p(partials), nblocks, p(s_out),
            p(n_out), p(a_out), kernels._stream(dev))
        kernels._check_cuda(lib, err, f"sx_fused on {nblocks} blocks")

    launch(rule.value)
    torch.cuda.synchronize()
    want_a, want_n = a_out.clone(), n_out.double().sum(-1)
    times = {}
    for per_sm in (1, 2, 3, 4, 4, 3, 2, 1):
        launch(per_sm * nsm)
        torch.cuda.synchronize()
        check(torch.equal(a_out, want_a),
              f"{per_sm} blocks per SM: accept decisions differ")
        dnll = float((n_out.double().sum(-1) - want_n).abs().max())
        ms = cuda_ms(torch, lambda: launch(per_sm * nsm), 3)
        times.setdefault(per_sm, []).append(ms / n * 1e3)
        print(f"{per_sm} blocks per SM: {ms / n * 1e3:.2f} us/step, "
              f"|dNLL| {dnll:.3g} against the rule's grid")
    rule_us = cuda_ms(torch, lambda: launch(rule.value), 3) / n * 1e3
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    print(f"rule: {rule.value // nsm} blocks per SM ({rule.value} blocks), "
          f"{rule_us:.2f} us/step; {nch} chain(s) x {n} steps on {smi}")
    print(json.dumps({"nchains": nch, "steps": n, "card": smi,
                      "rule_blocks_per_sm": rule.value // nsm,
                      "rule_us_per_step": rule_us,
                      "us_per_step_by_blocks_per_sm": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
