"""sxmc_tpu_torch.parallel.chain_sharded on 8 CPU shards: the summed
per-shard histograms equal the unsharded ones exactly, the walk equals
``metropolis.run_chain``'s stepper decision by decision on the same
draws (samples equal; NLLs within 1e-4, the float64 event sum added in
another order), and the posterior's moments are near the JAX package's
event-sharded chain (stored by
``tests/data/parallel_reference/make_reference.py``; the JAX test's
bar, 5 sigma / sqrt(50)), with the port's own draws."""

import numpy as np
import pytest
import torch

from sxmc_tpu_torch.mcmc import metropolis
from sxmc_tpu_torch.mcmc.metropolis import MCMC
from sxmc_tpu_torch.parallel import mesh as mesh_lib
from sxmc_tpu_torch.parallel.chain_sharded import (ShardedNLL,
                                                   run_sharded_chain)

from test_torch_mesh import GEN, REF

torch.set_num_threads(1)

CPU = torch.device("cpu")
MESH = mesh_lib.make_mesh(event=8, devices=[CPU] * 8)
WALK_STEPS = 300
MOMENT_STEPS = 4000  # the JAX moments are of an 8,000-step chain


def _model(tag):
    obs, systs, srcs, sigs = GEN.chain_fixture("sxmc_tpu_torch",
                                               tag == "syst")
    return MCMC(srcs, sigs, systs, [obs], device="cpu"), \
        REF[f"chain_{tag}_data"]


def _presampler(npar, seed):
    gen = torch.Generator().manual_seed(seed)
    drawn = {}

    def presample(k, n):
        if (k, n) not in drawn:
            drawn[(k, n)] = metropolis.presample(gen, n, npar, CPU)
        return drawn[(k, n)]

    return presample


def test_summed_histograms_equal_unsharded():
    mcmc, data = _model("syst")
    rb = mcmc.stack.compute_read_bins(data)
    nll = ShardedNLL(mcmc, rb, MESH)
    assert len(nll.shards) == 8 and nll.rebuild
    assert sum(x.shape[1] for _, x in nll.shards) == mcmc.stack.samples.shape[1]
    for tv in (0.0, 0.03, -0.07):
        theta = torch.tensor([tv], dtype=torch.float32)
        h, n = nll.histograms(theta)
        want_h, want_n = mcmc.stack.histograms(theta)
        assert torch.equal(h, want_h) and torch.equal(n, want_n)


@pytest.mark.parametrize("tag", ["fixed", "syst"])
def test_walk_equals_unsharded_stepper(tag):
    """``fixed`` (no systematic): run_chain's own route, the stepper with
    the LUT built once; ``syst`` (a floating shift): run_chain's stepper
    with the unsharded split NLL (B1, then B2, a step)."""
    mcmc, data = _model(tag)
    pres = _presampler(mcmc.nparameters, 5)
    ls = run_sharded_chain(mcmc, data, WALK_STEPS, 0.2, mesh=MESH,
                           presampler=pres)
    sharded_rate = mcmc.last_accept_rate
    mcmc.stack.set_data(data)
    rb = mcmc.stack.read_bins
    stepper = (None if tag == "fixed" else
               metropolis._chain_nll(mcmc, rb, allow_fused=False))
    s, nlls, rate = metropolis.run_chain(mcmc, rb, WALK_STEPS,
                                         int(WALK_STEPS * 0.2), False, pres,
                                         chain_nll=stepper)
    got = np.stack([ls.column(n) for n in mcmc.parameter_names], axis=1)
    np.testing.assert_array_equal(got, s.numpy())
    assert sharded_rate == float(rate) > 0
    np.testing.assert_allclose(ls.nll_values,
                               metropolis.nll_history_to_f64(nlls),
                               rtol=0, atol=1e-4)


def test_posterior_moments_near_jax():
    mcmc, data = _model("fixed")
    ls = run_sharded_chain(mcmc, data, MOMENT_STEPS, GEN.CHAIN_BURNIN,
                           mesh=MESH, seed=12)
    for k, name in enumerate(mcmc.parameter_names):
        m = ls.column(name).mean()
        m_ref, s_ref = REF["chain_fixed_mean"][k], REF["chain_fixed_std"][k]
        assert abs(m - m_ref) < 5 * s_ref / np.sqrt(50), (name, m, m_ref)
        assert 0.5 < ls.column(name).std() / s_ref < 2.0
