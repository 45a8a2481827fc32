"""One process of sxmc_tpu_torch's multi-process ensemble, for
tests/test_torch_multihost.py.

    python torch_multihost_worker.py <process_id> <num_processes>
        <init_method or "-"> <outdir>

joins the gloo process group at ``init_method`` (``file://...``), fits
its block of ``fit_config()``'s experiments on the CPU
(``parallel.multihost.run_multihost_ensemble``) and writes the gathered
limits to ``<outdir>/limits_<process_id>.json``.
"""

import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def fit_config():
    """A tiny fit: a floating shift on the signal (the grouped route), 4
    Poisson experiments of different lengths x 2 chains, 60 steps."""
    import importlib.util

    from sxmc_tpu_torch.fitconfig import FitConfig

    spec = importlib.util.spec_from_file_location(
        "parallel_make_reference",
        os.path.join(HERE, "data", "parallel_reference",
                     "make_reference.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    obs, systs, srcs, sigs = gen.chain_fixture("sxmc_tpu_torch", True)
    return FitConfig(nexperiments=4, nsteps=60, burnin_fraction=0.2,
                     seed=11, nchains=2, signal_name="sig",
                     observables=[obs], systematics=systs, sources=srcs,
                     signals=sigs)


def main():
    pid, nproc, init, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    from sxmc_tpu_torch.parallel import mesh as mesh_lib
    from sxmc_tpu_torch.parallel.multihost import run_multihost_ensemble

    if nproc > 1:
        assert mesh_lib.initialize_distributed(
            num_processes=nproc, process_id=pid, init_method=init)
    lspaces, limits = run_multihost_ensemble(fit_config(), device="cpu",
                                             verbose=False)
    with open(os.path.join(outdir, f"limits_{pid}.json"), "w") as f:
        json.dump({"process": pid, "nproc": mesh_lib.process_index_count()[1],
                   "local": [i for i, ls in enumerate(lspaces)
                             if ls is not None],
                   "limits": limits.tolist()}, f)
    if nproc > 1:
        # Leave the group in order.  Left to interpreter exit, gloo's
        # threads may be torn down under a live group, and the process
        # aborts ("terminate called without an active exception").
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
