"""Fits with KDE signals: the port's samplers and MLE against the JAX
package's, on ``test_torch_kde.make_kde_inputs`` (a KDE signal beside a
histogram, a floating shift on both).

The JAX runs are stored by tests/data/kde_reference/make_reference.py.
KDE stacks take the stepper route in both packages (accept ``u <=
exp(delta)``); fed JAX's streams the port's chains must decide as JAX's
step by step: every accept equal, parameters within 1e-5 relative
(float32 rounding of the KDE rows, test_torch_kde) and NLLs within 1e-3.
The HMC potential within 1e-5 relative and its gradient within 1e-4 of
the largest entry (autograd and jax.grad sum the events' float32 terms
in other orders).  The MLE within 1e-4 relative.
"""

import numpy as np
import pytest
import torch

from sxmc_tpu_torch import interop
from sxmc_tpu_torch.mcmc import metropolis as tm
from sxmc_tpu_torch.mcmc.hmc import HMC, _target

from test_torch_kde import make_kde_data, make_kde_inputs
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)
from test_torch_pooled import GEN, REF

torch.set_num_threads(1)


def _fed(tag: str, chains):
    return interop.presampler([
        tuple(np.stack([REF[f"met_{tag}_{x}_p{p}_c{c}"] for c in chains],
                       axis=1) if len(chains) > 1
              else REF[f"met_{tag}_{x}_p{p}_c{chains[0]}"]
              for x in ("noise", "u")) for p in range(3)])


def _same_walk(samples, nlls, tag: str, c: int):
    want = REF[f"met_{tag}_samples_c{c}"]
    moved = np.any(np.diff(samples, axis=0) != 0, axis=1)
    moved_j = np.any(np.diff(want, axis=0) != 0, axis=1)
    assert np.array_equal(moved, moved_j)  # the same decisions
    np.testing.assert_allclose(samples, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(nlls, REF[f"met_{tag}_nlls_c{c}"], rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("tag", ["grid", "exact"])
def test_metropolis_fed_jax_streams(tag):
    mc = tm.MCMC(*make_kde_inputs("sxmc_tpu_torch", exact=tag == "exact"),
                 device="cpu")
    assert not tm._fused_ok(mc)
    for c in range(GEN.MET_CHAINS):
        ls = mc(make_kde_data(), GEN.MET_STEPS, GEN.MET_BF,
                presampler=_fed(tag, [c]))
        _same_walk(ls.samples, ls.nll_values, tag, c)


def test_lockstep_chains_walk_as_jax_chains():
    """Two lock-step chains on the exact-KDE stack (B1-batched and the
    exact rows per chain) walk as JAX's two single chains."""
    mc = tm.MCMC(*make_kde_inputs("sxmc_tpu_torch", exact=True),
                 device="cpu")
    nch = GEN.MET_CHAINS
    ls = mc(make_kde_data(), GEN.MET_STEPS, GEN.MET_BF, nchains=nch,
            presampler=_fed("exact", list(range(nch))))
    keep = ls.samples.shape[0] // nch
    for c in range(nch):
        rows = slice(c * keep, (c + 1) * keep)
        _same_walk(ls.samples[rows], ls.nll_values[rows], "exact", c)


@pytest.mark.parametrize("tag", ["grid", "exact"])
def test_hmc_potential_and_gradient(tag):
    """The potential and its gradient in q, where theta's entry is
    finite and nonzero (the KDE row is smooth in theta), against JAX's
    potential and jax.grad; and MCMC.nll at the means."""
    hmc = HMC(*make_kde_inputs("sxmc_tpu_torch", exact=tag == "exact"),
              device="cpu")
    data = make_kde_data()
    hmc.stack.set_data(data)
    t = _target(hmc, hmc.stack.read_bins)
    np.testing.assert_allclose(t.q0.numpy(), REF[f"hmc_{tag}_q0"],
                               rtol=1e-6)
    for name in ("q0", "q1"):
        q = torch.as_tensor(REF[f"hmc_{tag}_{name}"])
        u, g = t.value_and_grad(q)
        np.testing.assert_allclose(float(u), REF[f"hmc_{tag}_u_{name}"],
                                   rtol=1e-5)
        want = REF[f"hmc_{tag}_g_{name}"]
        assert np.isfinite(g.numpy()).all() and abs(float(g[-1])) > 0
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
        assert float(t.value(q)) == float(u)
    assert hmc.nll(data, hmc.parameter_means) == pytest.approx(
        float(REF[f"nll_{tag}_means"]), rel=1e-6)


def test_mle_best_fit():
    """The MLE of the grid-KDE stack (the floating shift profiled on its
    grid, the rates by BFGS) lands on JAX's best fit."""
    from sxmc_tpu_torch.stats.mle import MLE

    res = MLE(*make_kde_inputs("sxmc_tpu_torch"), device="cpu").fit(
        make_kde_data())
    assert res.converged == bool(REF["mle_converged"])
    np.testing.assert_allclose(res.params, REF["mle_params"], rtol=1e-4,
                               atol=1e-6)
    assert res.nll == pytest.approx(float(REF["mle_nll"]), abs=1e-3)


def test_every_sampler_runs_on_exact_kde():
    """Tempering, the stretch move, NUTS and HMC with lock-step chains
    reach the exact rows through the same backend: finite chains."""
    from sxmc_tpu_torch.mcmc.nuts import NUTS
    from sxmc_tpu_torch.mcmc.stretch import StretchSampler
    from sxmc_tpu_torch.mcmc.tempered import TemperedMCMC

    inputs = make_kde_inputs("sxmc_tpu_torch", exact=True)
    data = make_kde_data()
    gen = torch.Generator().manual_seed(1)
    runs = {
        "tempered": TemperedMCMC(*inputs, device="cpu")(
            data, 40, 0.2, generator=gen),
        "stretch": StretchSampler(*inputs, device="cpu")(
            data, 20, 0.2, generator=gen),
        "nuts": NUTS(*inputs, device="cpu", max_depth=3)(
            data, 12, 0.5, generator=gen),
        "hmc": HMC(*inputs, device="cpu", num_leapfrog=4)(
            data, 12, 0.5, nchains=2, generator=gen)}
    for name, ls in runs.items():
        assert ls.samples.shape[0] > 0, name
        assert np.isfinite(ls.samples).all(), name
        assert np.isfinite(ls.nll_values).all(), name
