"""sxmc_tpu_torch.mcmc.hmc against the JAX package.

The JAX package's chains (two chains from fixed keys, at the inputs of
``test_torch_pdf.make_stack_inputs`` / ``make_data``) and the draws it
derived from its keys are stored by
``tests/data/sampler_reference/make_reference.py``: the JAX samplers
compile for minutes, so no test compiles one.  Fed those draws, the
port's chains (one chain, and the two as lock-step chains) must match
the JAX chains over their first sampling steps: parameters within 1e-4
relative and NLLs within 1e-3 absolute (float32 reductions run in
another order in XLA and in torch, and over 16 leapfrogs a step, or a
NUTS tree, the trajectories carry that rounding; an accept near a tie
may flip later).  Over the whole run the moments agree.  The helpers
here serve ``test_torch_nuts.py`` too, which holds NUTS the same way and
runs of both samplers on the port's generator against JAX runs of the
same length.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from sxmc_tpu_torch import interop
from sxmc_tpu_torch.mcmc import metropolis
from sxmc_tpu_torch.mcmc.hmc import HMC, _target
from sxmc_tpu_torch.mcmc.nuts import NUTS

from test_torch_pdf import make_data, make_stack_inputs
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

torch.set_num_threads(1)

REF_DIR = (pathlib.Path(__file__).resolve().parent / "data"
           / "sampler_reference")
FIRST = 8       # sampling steps compared element by element


def load_reference():
    """(the generator module with the inputs' constants, its answers)."""
    spec = importlib.util.spec_from_file_location(
        "sampler_make_reference", REF_DIR / "make_reference.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen, dict(np.load(REF_DIR / "reference.npz"))


GEN, REF = load_reference()
STEPS = {"hmc": (GEN.HMC_STEPS, GEN.HMC_BF),
         "nuts": (GEN.NUTS_STEPS, GEN.NUTS_BF)}
NDRAWS = {"hmc": 2, "nuts": 4}


def port(cls, binned: bool = False, fixed_b: bool = False):
    srcs, sigs, systs, obs = make_stack_inputs("sxmc_tpu_torch",
                                               n_mc=GEN.N_MC)
    if fixed_b:
        srcs[1].fixed = True
    return cls(srcs, sigs, systs, obs, device="cpu", binned=binned)


def jax_draws(tag: str, chains):
    """The stored JAX draws of ``chains`` as a port presampler."""
    return interop.draws_presampler([
        interop.chains_draws([[REF[f"{tag}_draws_p{p}_{i}_c{c}"]
                               for i in range(NDRAWS[tag])]
                              for c in chains]) for p in (0, 1)])


def run_fed(tag: str, chains, binned: bool = False):
    cls = HMC if tag == "hmc" else NUTS
    s = port(cls, binned)
    nsteps, bf = STEPS[tag]
    ls = s(make_data(nev=GEN.NEV), nsteps, bf, nchains=len(chains),
           presampler=jax_draws(tag, chains))
    keep = ls.samples.shape[0] // len(chains)
    return (s, ls.samples.reshape(len(chains), keep, -1),
            ls.nll_values.reshape(len(chains), keep))


@pytest.fixture(scope="module")
def fed():
    return {nch: run_fed("hmc", range(nch)) for nch in (1, 2)}


def check_first_steps(samples, nlls, pre: str, chains):
    want = REF[pre + "samples"][list(chains)]
    want_nll = REF[pre + "nlls"][list(chains)]
    np.testing.assert_allclose(samples[:, :FIRST], want[:, :FIRST],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(nlls[:, :FIRST], want_nll[:, :FIRST],
                               atol=1e-3)


def check_fed_run(run, tag: str, nch: int):
    """A port chain fed the JAX draws against the stored JAX chain."""
    s, samples, nlls = run
    check_first_steps(samples, nlls, tag + "_", range(nch))
    # Rates stay positive (log space); the whole run agrees in its
    # moments and its acceptance.
    assert (samples[..., :3] > 0).all()
    want = REF[tag + "_samples"][:nch].reshape(-1, 5)
    got = samples.reshape(-1, 5)
    np.testing.assert_allclose(got.mean(0), want.mean(0),
                               atol=0.5 * want.std(0).max())
    acc = float(np.mean(REF[tag + "_accept"][:nch]))
    assert abs(s.last_accept_rate - acc) < 0.1


def check_lock_step(fed):
    """Chain 0 of the lock-step pair walks as the chain run alone, over
    the steps before any rounding of the batched reductions shows."""
    np.testing.assert_allclose(fed[2][1][0, :FIRST], fed[1][1][0, :FIRST],
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("nch", [1, 2])
def test_chain_fed_jax_draws_matches_jax(fed, nch):
    check_fed_run(fed[nch], "hmc", nch)


def test_lock_step_chains_equal_single_chains(fed):
    check_lock_step(fed)


def test_binned_hmc_fed_jax_draws_matches_jax():
    s, samples, nlls = run_fed("hmc", range(2), binned=True)
    check_first_steps(samples, nlls, "hmc_binned_", range(2))


def test_binned_potential_equals_unbinned():
    """The binned NLL regroups the unbinned one exactly: the potential
    at the same point agrees to float32 rounding, and its gradient in
    the rates too (JAX test_hmc::test_binned_nll_values_match_unbinned)."""
    data = make_data(nev=GEN.NEV)
    vals = []
    for binned in (False, True):
        s = port(HMC, binned)
        s.stack.set_data(data)
        t = _target(s, s.stack.read_bins)
        q = t.q0 + torch.tensor([0.1, -0.07, 0.05, 0.0, 0.0])
        vals.append(t.value_and_grad(q))
    (u0, g0), (u1, g1) = vals
    assert abs(float(u0) - float(u1)) < 1e-4 * abs(float(u0))
    np.testing.assert_allclose(g1.numpy()[:3], g0.numpy()[:3], rtol=1e-3)
    # The event term's gradient in the systematics is 0: what is left is
    # the Gaussian constraint's.
    np.testing.assert_array_equal(g0.numpy()[3:], 0.0)


def test_potential_gradient_matches_finite_difference():
    """Autograd of the port's NLL in the rates against a float64 central
    difference of the same potential (the JAX package's gradient is
    held by the trajectories above)."""
    s = port(HMC)
    s.stack.set_data(make_data(nev=GEN.NEV))
    t = _target(s, s.stack.read_bins)
    q = t.q0 + torch.tensor([0.2, -0.1, 0.05, 0.0, 0.0])
    _, g = t.value_and_grad(q)
    evaluate, _, pair = metropolis._nll_backend(s, s.stack.read_bins)
    state = evaluate(torch.zeros(2))

    def u64(x):
        params = torch.where(torch.arange(5) < 3, torch.exp(x), x)
        hi, lo = pair(params, *state, s.nll_spec.consts)
        return float(hi) + float(lo) - float(x[:3].sum())

    for i in range(3):
        h = torch.zeros(5)
        h[i] = 1e-2
        fd = (u64(q + h) - u64(q - h)) / 2e-2
        assert abs(float(g[i]) - fd) < 2e-2 * max(abs(fd), 1.0), (i, fd)


def agree_statistically(got, want, nchains: int, ncols: int = 3):
    """Two runs of ``nchains`` chains each (rows chain-major): for each of
    the first ``ncols`` parameters, the mean over chains of the chains'
    means, and of their spreads, agree within 4 standard errors of the
    difference, each run's error taken from the scatter of its chains'
    values (batch means)."""
    for stat in (np.mean, np.std):
        g = stat(got[:, :ncols].reshape(nchains, -1, ncols), axis=1)
        w = stat(want[:, :ncols].reshape(nchains, -1, ncols), axis=1)
        se = np.sqrt((g.var(0, ddof=1) + w.var(0, ddof=1)) / nchains)
        diff = np.abs(g.mean(0) - w.mean(0))
        assert (diff <= 4 * se).all(), (stat.__name__, g.mean(0),
                                         w.mean(0), se)


def test_evaluations_are_counted():
    """17 evaluations an HMC step (the gradient at the start, one a
    leapfrog), one more for the initial potential."""
    s = port(HMC)
    s(make_data(nev=GEN.NEV), 12, 0.5,
      generator=torch.Generator().manual_seed(1))
    assert s.last_evaluations == 1 + 12 * 17
    assert s.last_leapfrogs_per_step == 16.0

