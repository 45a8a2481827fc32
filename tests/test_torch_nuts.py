"""sxmc_tpu_torch.mcmc.nuts against the JAX package, and both gradient
samplers on the port's own generator.

As ``test_torch_hmc.py`` (its helpers and stored JAX answers): fed the
draws the JAX package derived from its keys (per step the momentum, per
level the direction, merge and leaf uniforms), the port's NUTS chains
(one chain, and two as lock-step chains) match the JAX chains over
their first sampling steps, parameters within 1e-4 relative and NLLs
within 1e-3 absolute.  HMC and NUTS on the port's generator agree
statistically (batch means) with JAX runs of the same steps, burn-in
and chain count, and pin a fixed parameter.
"""

import numpy as np
import pytest
import torch

from sxmc_tpu_torch.mcmc.hmc import HMC
from sxmc_tpu_torch.mcmc.nuts import NUTS

from test_torch_hmc import (GEN, REF, agree_statistically, check_fed_run,
                            check_lock_step, port, run_fed)
from test_torch_pdf import make_data
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fed():
    return {nch: run_fed("nuts", range(nch)) for nch in (1, 2)}


@pytest.mark.parametrize("nch", [1, 2])
def test_chain_fed_jax_draws_matches_jax(fed, nch):
    check_fed_run(fed[nch], "nuts", nch)


def test_lock_step_chains_equal_single_chains(fed):
    check_lock_step(fed)


@pytest.mark.parametrize("tag", ["hmc", "nuts"])
def test_own_generator_agrees_statistically(tag):
    """Lock-step chains on the port's generator against the JAX run of
    the same steps, burn-in and chain count (``*_stat_samples``)."""
    s = port(HMC if tag == "hmc" else NUTS)
    nsteps = GEN.HMC_STAT_STEPS if tag == "hmc" else GEN.NUTS_STAT_STEPS
    ls = s(make_data(nev=GEN.NEV), nsteps, GEN.STAT_BF,
           nchains=GEN.STAT_CHAINS, generator=torch.Generator().manual_seed(5))
    want = REF[tag + "_stat_samples"]
    assert ls.samples.shape == want.shape
    agree_statistically(ls.samples, want, GEN.STAT_CHAINS)


@pytest.mark.parametrize("cls", [HMC, NUTS])
def test_fixed_parameter_pinned(cls):
    s = port(cls, fixed_b=True)
    ls = s(make_data(nev=GEN.NEV), 16, 0.5,
           generator=torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(ls.column("b"), np.float32(1.0))
    assert (ls.column("a") > 0).all()
